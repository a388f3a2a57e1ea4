"""Resumable training sessions: checkpoint/resume, eval + plateau LR,
JSONL metrics."""
from repro_torch.train_loop.eval import (EVAL_SEED_OFFSET, alexnet_metrics,
                                         lm_metrics, run_eval, take)
from repro_torch.train_loop.metrics import MetricsWriter, read_jsonl
from repro_torch.train_loop.session import SessionResult, TrainSession

__all__ = ["EVAL_SEED_OFFSET", "MetricsWriter", "SessionResult",
           "TrainSession", "alexnet_metrics", "lm_metrics", "read_jsonl",
           "run_eval", "take"]
