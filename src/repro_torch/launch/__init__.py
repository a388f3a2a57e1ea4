"""Command-line entry points of the port."""


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error for a reference flag value the port does not run yet."""
    return NotImplementedError(f"{what} is not ported yet: see ROADMAP.md "
                               f"{item}")
