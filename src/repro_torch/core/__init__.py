"""The paper's contribution: data parallelism by parameter averaging."""
