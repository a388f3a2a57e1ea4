"""The mesh engine (``make_mesh_param_avg_step``: one replica per rank of a
``torch.distributed`` group) on two gloo CPU ranks, held against the
port's axis-0 engine (``make_param_avg_step``) on the same weights and
batches.  The reference's own mesh tests cannot run on this host, so the
axis-0 engine, which the reference is held to in test_torch_train.py and
test_torch_exchange.py, is the yardstick.

One module-scoped spawn runs every case on both ranks (this file run as
a script; the ranks import torch and the port only) and hands rank 0's
gathered (R, ...) states back through ``torch.save``:

* ``all_reduce`` and ``pairwise`` at R = 2, delay 0 and 1: bit-equal;
* ``ring`` and top-k (delay 1): within ``STEP_TOL``;
* the bf16 preset with one rank's batch poisoned: the finite flag is
  ANDed over the ranks, so both skip;
* ``sync_every=2``;
* checkpoints: a mesh checkpoint resumed on the axis-0 engine, and an
  axis-0 checkpoint resumed on the mesh.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import checkpoint, numerics
from repro_torch.configs import alexnet as port_cfgs
from repro_torch.core import param_avg, steps
from repro_torch.models import alexnet
from repro_torch.optim import optimizers, schedules
from repro_torch.tree import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
WORLD = 2
IMAGE_SIZE = 48
STEP_TOL = 1e-4          # test_torch_train.py's
CFG = dataclasses.replace(port_cfgs.FAITHFUL_SMOKE, image_size=IMAGE_SIZE)
BF16 = numerics.get_policy("bf16")

# name -> (model, ExchangeConfig kwargs, bf16 preset, poisoned (step,
# replica) or None, steps)
CASES = {
    "all_reduce": ("alexnet", dict(), False, None, 3),
    "all_reduce_delay1": ("alexnet", dict(delay=1), False, None, 3),
    "pairwise": ("alexnet", dict(strategy="pairwise"), False, None, 3),
    "pairwise_delay1": ("alexnet", dict(strategy="pairwise", delay=1),
                        False, None, 3),
    "ring_delay1": ("alexnet", dict(strategy="ring", delay=1), False, None,
                    3),
    "topk": ("alexnet", dict(delay=1, compression="topk", topk_frac=0.05),
             False, None, 3),
    "sync_every2": ("alexnet", dict(delay=1, compression="bf16",
                                    sync_every=2), False, None, 4),
    "poisoned": ("linear", dict(), True, (1, 1), 3),
}
BIT_EQUAL = {"all_reduce", "all_reduce_delay1", "pairwise",
             "pairwise_delay1", "poisoned", "sync_every2"}
# checkpointed after 2 of its 4 steps, resumed on the other engine
RESUMED = {"ckpt": ("alexnet", dict(delay=1, compression="topk",
                                    topk_frac=0.05), False, None, 4)}


def _ckpt_exchange():
    return param_avg.ExchangeConfig(**RESUMED["ckpt"][1])


def _alexnet_loss(p, b):
    return alexnet.loss_fn(p, CFG, b["images"], b["labels"])


def _linear_loss(p, batch):
    x, y = batch["images"], batch["labels"]
    logits = x @ p["w"].to(x.dtype) + p["b"].to(x.dtype)
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, y[:, None].long()).mean()


def _init(model, n_rep, exchange, policy):
    def params(gen):
        if model == "linear":
            return {"w": torch.randn(8, 4, generator=gen) * 0.1,
                    "b": torch.zeros(4)}
        return tree_map(lambda p: p.detach(),
                        alexnet.init(CFG, gen, device="cpu").params())

    def init_fn(gen):
        out = params(gen)
        return out if policy is None else tree_map(
            lambda p: p.to(torch.bfloat16), out)

    return steps.init_param_avg_state(
        torch.Generator().manual_seed(0), init_fn, _opt(policy), n_rep,
        exchange=exchange, numerics=policy)


def _opt(policy):
    return optimizers.for_numerics(optimizers.get_optimizer("sgd_momentum"),
                                   policy)


def _batches(model, n, poison=None):
    """(R, 4, ...) numpy batches; ``poison`` (step, replica) puts a NaN
    in that replica's first input."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        if model == "linear":
            b = {"images": rng.normal(size=(WORLD, 4, 8)).astype(np.float32),
                 "labels": rng.integers(0, 4, (WORLD, 4)).astype(np.int32)}
        else:
            b = {"images": rng.standard_normal(
                    (WORLD, 4, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32),
                 "labels": rng.integers(0, 10, (WORLD, 4)).astype(np.int32)}
        if poison is not None and i == poison[0]:
            b["images"].reshape(WORLD, -1)[poison[1], 0] = np.nan
        out.append(b)
    return out


def _step(model, exchange, policy, group=None):
    loss = _linear_loss if model == "linear" else _alexnet_loss
    kw = dict(strategy=exchange, numerics=policy)
    if group is None:
        return steps.make_param_avg_step(loss, _opt(policy),
                                         schedules.constant(0.05), **kw)
    return steps.make_mesh_param_avg_step(loss, _opt(policy),
                                          schedules.constant(0.05),
                                          group=group, **kw)


def run(name, group=None, state=None, first=0, last=None):
    """Case ``name`` on the axis-0 engine (``group`` None) or on this
    rank: (losses, final state).  ``state`` overrides the fresh one;
    batches ``first`` to ``last`` are taken."""
    model, ex_kw, bf16, poison, n = {**CASES, **RESUMED}[name]
    exchange = param_avg.ExchangeConfig(**ex_kw)
    policy = BF16 if bf16 else None
    if state is None:
        state = _init(model, WORLD if group is None else 1, exchange,
                      policy)
    step = _step(model, exchange, policy, group)
    losses = []
    for b in _batches(model, n, poison)[first:last]:
        if group is not None:
            b = tree_map(lambda x: x[group.rank:group.rank + 1], b)
        state, loss = step(state, tree_map(torch.from_numpy, b))
        losses.append(loss.item())
    return losses, state


def rank_main(rank, init, outdir):
    from repro_torch.launch import mesh
    group = mesh.init_replica_group(rank, WORLD, init, torch.device("cpu"))
    try:
        out = {}
        for name in CASES:
            losses, state = run(name, group)
            out[name] = (losses, steps.gather_state(state, group))
        # a mesh checkpoint after 2 steps, for the axis-0 engine to resume
        _, state = run("ckpt", group, last=2)
        full = steps.gather_state(state, group)
        if rank == 0:
            checkpoint.save(os.path.join(outdir, "mesh_ckpt"), 2, full)
        # the axis-0 engine's checkpoint after 2 steps, resumed here
        like = _init("alexnet", 1, _ckpt_exchange(), None)
        restored = checkpoint.restore(os.path.join(outdir, "axis0_ckpt"), 2,
                                      like)
        losses, state = run("ckpt", group,
                            state=steps.local_state(restored, rank),
                            first=2)
        out["resumed_on_mesh"] = (losses, steps.gather_state(state, group))
        if rank == 0:
            torch.save(out, os.path.join(outdir, "mesh.pt"))
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    from repro_torch.launch import mesh
    out = tmp_path_factory.mktemp("mesh")
    _, state = run("ckpt", last=2)
    checkpoint.save(str(out / "axis0_ckpt"), 2, state)
    init = f"tcp://127.0.0.1:{mesh.free_port()}"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen([sys.executable, __file__, str(r), init,
                               str(out)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return out, torch.load(out / "mesh.pt", weights_only=False)


def _state_trees(state):
    return (state.params, state.opt_state, state.exchange, state.numerics)


def _compare(got, want, exact):
    """(max abs difference) of two states' tensors; with ``exact`` every
    leaf must be bit-equal."""
    err = 0.0
    for a, b in zip(tree_leaves(_state_trees(got)),
                    tree_leaves(_state_trees(want)), strict=True):
        assert a.shape == b.shape and a.dtype == b.dtype
        if exact:
            assert torch.equal(a, b)
        err = max(err, (a.double() - b.double()).abs().max().item())
    return err


@pytest.mark.parametrize("name", list(CASES))
def test_mesh_engine_matches_the_axis0_engine(mesh_runs, name):
    _, results = mesh_runs
    got_losses, got = results[name]
    want_losses, want = run(name)
    exact = name in BIT_EQUAL
    assert got.step == want.step == CASES[name][4]
    for a, b in zip(got_losses, want_losses, strict=True):
        assert (np.isnan(a) and np.isnan(b)) or (
            a == b if exact else abs(a - b) <= STEP_TOL)
    err = _compare(got, want, exact)
    assert err <= STEP_TOL
    if name == "poisoned":
        assert np.isnan(got_losses[1])
        assert int(got.numerics["skipped"]) == 1
        assert float(got.numerics["scale"]) == 2.0 ** 14
    if got.exchange is not None:
        assert param_avg.replica_spread(got.exchange["base"]) == 0.0


def test_a_mesh_checkpoint_resumes_on_the_axis0_engine(mesh_runs):
    out, _ = mesh_runs
    _, straight = run("ckpt")
    like = _init("alexnet", WORLD, _ckpt_exchange(), None)
    restored = checkpoint.restore(str(out / "mesh_ckpt"), 2, like)
    assert restored.step == 2
    _, resumed = run("ckpt", state=restored, first=2)
    assert _compare(resumed, straight, exact=False) <= STEP_TOL


def test_an_axis0_checkpoint_resumes_on_the_mesh(mesh_runs):
    _, results = mesh_runs
    want_losses, straight = run("ckpt")
    losses, resumed = results["resumed_on_mesh"]
    assert resumed.step == 4
    assert all(abs(a - b) <= STEP_TOL
               for a, b in zip(losses, want_losses[2:], strict=True))
    assert _compare(resumed, straight, exact=False) <= STEP_TOL


if __name__ == "__main__":
    rank_main(int(sys.argv[1]), sys.argv[2], sys.argv[3])
