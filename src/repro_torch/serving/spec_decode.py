"""Speculative decoding (the counterpart of ``repro/serving/spec_decode.py``):
a draft model proposes ``gamma`` greedy tokens, the target scores the
whole chunk in one chunked forward, and one round runs per dispatch.

    x      = [t0, d1 .. dγ]          t0 = last engine token, d = drafts
    tgt[j] = argmax target logits after consuming x[:j+1]
    m      = Σ cumprod(d_{j+1} == tgt[j])        accepted draft count
    a      = m + 1                               tokens emitted (>= 1)

The emitted tokens are ``tgt[0..m]``: the accepted drafts equal the
target's own greedy chain, and the last is the target's correction, so
the stream is token for token the plain greedy engine's.  The target's
verify (``models.decode_seq_pending``) writes nothing; its commit
(``models.commit_pending``) writes the accepted prefix from the same
pending chunk, so a round costs one target forward.  The draft re-runs
its cheap chunk (``models.decode_seq``) to advance its own state.

The draft's propose ticks run ``models.decode_step``, which writes the
draft's cache in place, where the reference's functional ticks leave
the state they started from alone.  So ``spec_round`` copies what the
ticks overwrite before them and puts it back after them: each ring's
``gamma`` slots from ``pos`` per row, which on a wrapped or windowed
ring still hold positions the draft's verify counts as visible, and the
recurrent leaves whole, which its commit re-runs from.  The draft's
state after a round is then the reference's, and the copies cost
``gamma`` ring slots per row per attention layer plus the recurrent
state, not the rings.

One packed (slots, 2(γ+1)+1) tensor (emitted tokens, eos flags, each
row's accept count) crosses to the host per dispatch.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import models
from repro_torch.models import transformer
from repro_torch.tree import tree_map

# the families whose decode_seq the reference drafts for and with
SPEC_FAMILIES = ("dense", "moe", "ssm", "hybrid")

# the leaves of an attention layer's ring in the decode cache
_RING = ("k", "v", "k_scale", "v_scale")


def check_spec_pair(tcfg, dcfg, *, temperature: float, ticks: int) -> None:
    """Validate a (target, draft) engine configuration: greedy only, one
    tick per dispatch, families the port serves and the reference drafts
    for, one vocabulary."""
    if temperature != 0.0:
        raise ValueError("speculative decoding is greedy-only "
                         f"(temperature=0), got temperature={temperature}")
    if ticks != 1:
        raise ValueError("speculative decoding replaces the multi-tick "
                         f"dispatch; use ticks_per_dispatch=1, got {ticks}")
    for name, cfg in (("target", tcfg), ("draft", dcfg)):
        if cfg.family not in models.FAMILIES:
            raise NotImplementedError(
                f"a {cfg.family!r} {name} ({cfg.name}) is not ported yet: "
                "see ROADMAP.md queue A item 8 (A8b: vlm; A8c: encdec)")
        if cfg.family not in SPEC_FAMILIES:
            raise NotImplementedError(
                f"spec decode needs a {SPEC_FAMILIES} {name}, got "
                f"{cfg.family!r} ({cfg.name})")
    if tcfg.vocab_size != dcfg.vocab_size:
        raise ValueError(
            f"draft/target vocabularies differ: {dcfg.vocab_size} vs "
            f"{tcfg.vocab_size}; acceptance compares token ids directly")


def truncated_draft(cfg, params, k: int):
    """The target's own first ``k`` layers as a draft: (draft config,
    draft params).  Layers run superblock-major, so the draft keeps the
    first ``k // P`` superblocks (P = the pattern's length) stacked and
    the next ``k % P`` pattern positions as remainder layers, the order
    the target runs them in.  Every leaf is a view of the target's
    (``x[:j]``, ``x[j]``, the remainder layers themselves), so the draft
    costs no memory beyond its own decode state."""
    if cfg.family not in SPEC_FAMILIES:
        raise NotImplementedError(
            f"spec decode needs a {SPEC_FAMILIES} target, got "
            f"{cfg.family!r} ({cfg.name})")
    pattern, n_super, _ = transformer._split(cfg)
    if not 0 < k < cfg.n_layers:
        raise ValueError(f"draft layers must be in (0, {cfg.n_layers}), "
                         f"got {k}")
    j, r = divmod(k, len(pattern))
    dcfg = dataclasses.replace(cfg, n_layers=k, name=f"{cfg.name}-draft{k}")
    dparams = {"embed": params["embed"], "final_norm": params["final_norm"],
               "blocks": tuple(tree_map(lambda x: x[:j], bp)
                               for bp in params["blocks"]) if j else ()}
    if r == 0:
        rems = ()
    elif j < n_super:
        # the partial superblock: stack index j of pattern positions < r
        rems = tuple(tree_map(lambda x: x[j], params["blocks"][pi])
                     for pi in range(r))
    else:
        rems = tuple(params["rem_blocks"][:r])
    dparams["rem_blocks"] = rems
    return dcfg, dparams


def _snapshot(state, n: int) -> list:
    """(leaf, index, copy) for what ``n`` decode steps from ``state.pos``
    overwrite in ``state.cache``: each ring's slots ``pos .. pos+n-1``
    (mod its capacity) per row, every recurrent leaf whole."""
    pos = state.pos.long()
    rows = torch.arange(pos.shape[0], device=pos.device)[:, None]
    steps = torch.arange(n, device=pos.device)
    saved = []

    def walk(tree, lead):
        for key, leaf in tree.items():
            if isinstance(leaf, dict):
                walk(leaf, lead)
                continue
            if key in _RING:
                cap = leaf.shape[len(lead) + 1]
                idx = lead + (rows, torch.remainder(pos[:, None] + steps,
                                                    cap))
            else:
                idx = (Ellipsis,)
            saved.append((leaf, idx, leaf[idx].clone()))

    for tree in state.cache["blocks"]:
        walk(tree, (slice(None),))        # stacked: the layer axis leads
    for tree in state.cache["rem_blocks"]:
        walk(tree, ())
    return saved


def _restore(saved) -> None:
    for leaf, idx, copy in saved:
        leaf[idx] = copy


@torch.no_grad()
def spec_round(tparams, tcfg, dparams, dcfg, tstate, dstate, toks,
               gamma: int, eos_id=None):
    """One propose + verify + commit round for every slot: ``toks``
    (slots, 1) are the last tokens, at ``tstate.pos`` = ``dstate.pos``.
    Returns (packed (slots, 2(γ+1)+1): [emit 0..γ | eos flags 0..γ | a],
    of which each row's first ``a`` emit and flag entries count; the
    last token (slots, 1); the target's and the draft's DecodeStates,
    advanced in place by ``a``).  ``gamma = 0`` is a plain verified tick
    (a = 1)."""
    x = toks
    if gamma > 0:
        saved = _snapshot(dstate, gamma)
        st, tk, drafts = dstate, toks, []
        for _ in range(gamma):
            logits, st = models.decode_step(dparams, dcfg, st, tk)
            tk = logits[:, 0].argmax(-1, keepdim=True)
            drafts.append(tk)
        _restore(saved)
        x = torch.cat([toks] + drafts, 1)                   # (slots, γ+1)
    tlogits, pending = models.decode_seq_pending(tparams, tcfg, tstate, x)
    tgt = tlogits.argmax(-1)                                # (slots, γ+1)
    m = torch.cumprod((x[:, 1:] == tgt[:, :-1]).long(), 1).sum(1)
    a = m + 1
    tstate = models.commit_pending(tparams, tcfg, tstate, pending, a)
    _, dstate = models.decode_seq(dparams, dcfg, dstate, x, a)
    flags = torch.zeros_like(tgt) if eos_id is None \
        else (tgt == eos_id).long()
    packed = torch.cat([tgt, flags, a[:, None]], 1)
    return packed, tgt.gather(1, m[:, None]), tstate, dstate
