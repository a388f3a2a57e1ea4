"""The port's trainer against the reference's: the exchange strategies,
the parameter-averaging step, loss traces, checkpoints both ways, resume
and the CLI.

The reference runs live on the CPU (its ``make_param_avg_step`` on its
default ``vmap`` path); the port runs its replicas one after another.
Weights come from ``repro.models.init`` through the bridge, batches from
numpy.
"""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import checkpoint, weights
from repro_torch.configs import alexnet as port_cfgs
from repro_torch.core import param_avg, steps
from repro_torch.launch import train as train_cli
from repro_torch.models import alexnet
from repro_torch.optim import optimizers, schedules
from repro_torch.train_loop import alexnet_metrics, read_jsonl
from repro_torch.tree import tree_leaves, tree_map

try:
    import jax
    import jax.numpy as jnp

    from repro import checkpoint as jax_ckpt
    from repro import core as jax_core
    from repro import models as jax_models
    from repro.configs import alexnet as jax_cfgs
    from repro.core import param_avg as jax_pa
    from repro.optim import optimizers as jax_opt
    from repro.optim import schedules as jax_sched
    from repro.train_loop import eval as jax_eval
except ImportError:
    jax = None

ROOT = Path(__file__).resolve().parents[1]
IMAGE_SIZE = 48
STEP_TOL = 1e-4
TRACE_DRIFT = 5e-3       # test_golden_traces.py's cross-backend tolerance


def _pair(name):
    return (dataclasses.replace(getattr(jax_cfgs, name),
                                image_size=IMAGE_SIZE),
            dataclasses.replace(getattr(port_cfgs, name),
                                image_size=IMAGE_SIZE))


def _batches(cfg, n, shape_prefix, seed=0):
    rng = np.random.default_rng(seed)
    return [{"images": rng.standard_normal(
                shape_prefix + (IMAGE_SIZE, IMAGE_SIZE, 3)).astype(
                    np.float32),
             "labels": rng.integers(0, cfg.n_classes,
                                    shape_prefix).astype(np.int32)}
            for _ in range(n)]


def _close(got, want, tol):
    """Port tree (tensors) against a reference tree, leaf by leaf."""
    tree_map(lambda g, w: np.testing.assert_allclose(
        g.detach().numpy(), np.asarray(w), rtol=tol, atol=tol), got, want)


@pytest.mark.parametrize("r", [2, 4])
@pytest.mark.parametrize("strategy", ["all_reduce", "ring", "pairwise",
                                      "none"])
def test_exchange_strategies_match_reference(strategy, r):
    rng = np.random.default_rng(r)
    tree = {"a": rng.normal(size=(r, 3, 5)).astype(np.float32),
            "b": [rng.normal(size=(r, 7)).astype(np.float32)],
            "count": np.asarray(3, np.int32)}
    got = param_avg.Exchanger(strategy).average(
        tree_map(torch.from_numpy, tree))
    want = jax_pa.Exchanger(strategy).average(
        jax.tree.map(jnp.asarray, tree))
    _close(got, want, 1e-6)
    spread = param_avg.replica_spread(tree_map(torch.from_numpy, tree))
    assert spread == pytest.approx(float(jax_pa.replica_spread(tree)),
                                   rel=1e-6)


def test_exchange_options_not_ported_raise():
    """The overlapped exchange and its compressions are ported: the
    port's ``ExchangeConfig`` takes and refuses what the reference's
    does, with the same messages, and describes itself the same way."""
    for kw in (dict(), dict(sync_every=2), dict(delay=1),
               dict(delay=1, compression="bf16"), dict(compression="bf16"),
               dict(delay=1, compression="topk", topk_frac=0.05),
               dict(strategy="ring", delay=1, sync_every=3)):
        assert param_avg.ExchangeConfig(**kw).describe() == \
            jax_pa.ExchangeConfig(**kw).describe()
    for kw in (dict(delay=2), dict(sync_every=0), dict(strategy="gossip"),
               dict(compression="zip"), dict(compression="topk"),
               dict(compression="topk", delay=1, topk_frac=0.0),
               dict(compression="topk", delay=1, strategy="ring")):
        with pytest.raises(ValueError) as want:
            jax_pa.ExchangeConfig(**kw)
        with pytest.raises(ValueError) as got:
            param_avg.ExchangeConfig(**kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="power-of-two"):
        param_avg.Exchanger("pairwise").average(torch.zeros(3, 2))


@pytest.mark.parametrize("sync_every", [1, 2])
def test_param_avg_steps_match_reference(sync_every):
    """3 steps of the paper's step, R=2, on FAITHFUL_SMOKE@48: the loss
    of every step, then params and momentum."""
    jcfg, cfg = _pair("FAITHFUL_SMOKE")
    jstate = jax_core.init_param_avg_state(
        jax.random.PRNGKey(0), lambda r: jax_models.init(r, jcfg),
        jax_opt.sgd_momentum(), 2)
    state = weights.state_from_reference(jstate, cfg, device="cpu")
    jstep = jax.jit(jax_core.make_param_avg_step(
        lambda p, b: jax_models.loss_fn(p, jcfg, b),
        jax_opt.sgd_momentum(), jax_sched.constant(0.01),
        strategy="all_reduce", sync_every=sync_every))
    step = steps.make_param_avg_step(
        lambda p, b: alexnet.loss_fn(p, cfg, b["images"], b["labels"]),
        optimizers.sgd_momentum(), schedules.constant(0.01),
        strategy="all_reduce", sync_every=sync_every)
    for batch in _batches(jcfg, 3, (2, 4)):
        jstate, jloss = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        state, loss = step(state, tree_map(torch.from_numpy, batch))
        assert abs(loss.item() - float(jloss)) <= STEP_TOL
    assert state.step == int(jstate.step) == 3
    _close(state.params, jstate.params, STEP_TOL)
    _close(state.opt_state, jstate.opt_state, STEP_TOL)
    spread = param_avg.replica_spread(state.params)
    assert (spread == 0.0) == (sync_every == 1)


@pytest.mark.parametrize("name", ["SMOKE", "FAITHFUL_SMOKE"])
def test_twenty_step_trace_matches_reference(name):
    """The golden-trace protocol (plain SGD momentum 0.9, LR 0.01, batch
    4) run live on both sides over the same numpy batches."""
    jcfg, cfg = _pair(name)
    params = jax_models.init(jax.random.PRNGKey(0), jcfg)
    mom = jax.tree.map(jnp.zeros_like, params)

    @jax.jit
    def jstep(params, mom, batch):
        loss, g = jax.value_and_grad(
            lambda p: jax_models.loss_fn(p, jcfg, batch))(params)
        mom = jax.tree.map(lambda m, d: 0.9 * m + d, mom, g)
        params = jax.tree.map(lambda p, m: p - 0.01 * m, params, mom)
        return params, mom, loss

    state = steps.init_param_avg_state(
        None, lambda _: tree_map(lambda a: torch.tensor(np.asarray(a)),
                                 params),
        optimizers.sgd_momentum(momentum=0.9, weight_decay=0.0), 1)
    step = steps.make_param_avg_step(
        lambda p, b: alexnet.loss_fn(p, cfg, b["images"], b["labels"]),
        optimizers.sgd_momentum(momentum=0.9, weight_decay=0.0),
        schedules.constant(0.01), strategy="none")
    want, got = [], []
    for batch in _batches(jcfg, 20, (4,), seed=7):
        params, mom, jloss = jstep(params, mom,
                                   jax.tree.map(jnp.asarray, batch))
        state, loss = step(state, tree_map(
            lambda x: torch.from_numpy(x)[None], batch))
        want.append(float(jloss))
        got.append(loss.item())
    drift = float(np.max(np.abs(np.asarray(got) - np.asarray(want))))
    print(f"{name}: 20-step max loss drift {drift:.3e}")
    assert np.all(np.isfinite(got))
    assert drift <= TRACE_DRIFT


def test_eval_metrics_match_reference():
    jcfg, cfg = _pair("FAITHFUL_SMOKE")
    params = jax.tree.map(np.asarray,
                          jax_models.init(jax.random.PRNGKey(2), jcfg))
    batch = _batches(jcfg, 1, (8,), seed=3)[0]
    want = jax_eval.alexnet_metrics(jcfg)(
        params, jax.tree.map(jnp.asarray, batch))
    got = alexnet_metrics(cfg)(tree_map(torch.tensor, params),
                               tree_map(torch.from_numpy, batch))
    for k in ("loss", "top1_err"):
        assert float(got[k]) == pytest.approx(float(want[k]), abs=1e-5)
    stacked = tree_map(lambda a: torch.from_numpy(np.stack([a, a])), params)
    mean = steps.make_eval_step(alexnet_metrics(cfg))(
        stacked, tree_map(torch.from_numpy, batch))
    assert float(mean["loss"]) == pytest.approx(float(got["loss"]), abs=1e-6)


def _ref_state(jcfg, seed=0):
    return jax_core.init_param_avg_state(
        jax.random.PRNGKey(seed), lambda r: jax_models.init(r, jcfg),
        jax_opt.sgd_momentum(), 2)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jcfg, cfg = _pair("FAITHFUL_SMOKE")
    jstate = _ref_state(jcfg)
    jstate = dataclasses.replace(jstate, step=jnp.asarray(5, jnp.int32))
    jax_ckpt.save(str(tmp_path), 5, jstate, meta={"batches_consumed": 5})
    like = weights.state_from_reference(_ref_state(jcfg, seed=1), cfg,
                                        device="cpu")
    assert checkpoint.latest_step(str(tmp_path)) == 5
    got = checkpoint.restore(str(tmp_path), 5, like)
    want = weights.state_from_reference(jstate, cfg, device="cpu")
    assert got.step == want.step == 5
    tree_map(lambda a, b: a.numpy().tobytes() == b.numpy().tobytes()
             or pytest.fail("restored leaf differs"),
             (got.params, got.opt_state), (want.params, want.opt_state))
    assert checkpoint.load_meta(str(tmp_path), 5) == {"batches_consumed": 5}


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jcfg, cfg = _pair("SMOKE")
    jstate = _ref_state(jcfg, seed=3)
    state = weights.state_from_reference(jstate, cfg, device="cpu")
    state = dataclasses.replace(state, step=7)
    checkpoint.save(str(tmp_path), 7, state)
    os.makedirs(tmp_path / "step_00000009.tmp")     # an interrupted save
    assert checkpoint.latest_step(str(tmp_path)) == 7
    got = jax_ckpt.restore(str(tmp_path), 7, _ref_state(jcfg, seed=4))
    want = jax_core.TrainState(**weights.state_to_reference(state))
    assert int(got.step) == 7
    for a, b in zip(jax.tree.leaves((got.params, got.opt_state)),
                    jax.tree.leaves((want.params, want.opt_state))):
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()


CLI = ["--arch", "alexnet", "--smoke", "--faithful", "--image-size", "48",
       "--batch", "8", "--replicas", "2", "--device", "cpu",
       "--log-every", "100"]


def test_resume_repeats_an_uninterrupted_run(tmp_path):
    """6 steps straight, and 3 steps + resume + 3 steps, give
    bit-identical losses and params (CPU, in-process CLI)."""
    straight = train_cli.main(CLI + ["--steps", "6", "--metrics-out",
                                      str(tmp_path / "a.jsonl")])
    ck = str(tmp_path / "ck")
    path = str(tmp_path / "b.jsonl")
    first = train_cli.main(CLI + ["--steps", "3", "--ckpt-dir", ck,
                                  "--ckpt-every", "3", "--metrics-out", path])
    resumed = train_cli.main(CLI + ["--steps", "6", "--ckpt-dir", ck,
                                    "--resume", "--metrics-out", path])
    assert (first.final_step, resumed.start_step, resumed.final_step) == \
        (3, 3, 6)
    want = [r["loss"] for r in read_jsonl(str(tmp_path / "a.jsonl"),
                                          "train")]
    got = [r["loss"] for r in read_jsonl(path, "train")]
    assert len(want) == 6 and got == want
    tree_map(lambda a, b: torch.equal(a, b) or pytest.fail("params differ"),
             resumed.state.params, straight.state.params)


def test_plateau_schedule_drives_eval(tmp_path):
    path = str(tmp_path / "m.jsonl")
    res = train_cli.main(CLI + ["--steps", "4", "--schedule", "plateau",
                                "--eval-every", "1", "--eval-batches", "1",
                                "--plateau-patience", "1",
                                "--metrics-out", path])
    evals = read_jsonl(path, "eval")
    assert [e["step"] for e in evals] == [1, 2, 3, 4]
    assert all(0.0 <= e["top1_err"] <= 1.0 for e in evals)
    assert res.lr_drops == [e["step"] for e in evals if e["lr_dropped"]]
    summary = read_jsonl(path, "summary")[-1]
    assert summary["timed_steps"] == 3 and summary["images_per_sec"] > 0


@pytest.mark.parametrize("extra,match", [
    (["--arch", "phi-3-vision-4.2b"], "ROADMAP.md queue A item 8"),
    (["--model-parallel", "2"], "ROADMAP.md queue A item 12"),
    # the mesh engine (queue A item 4) is ported: two gloo ranks train,
    # and the reference engine resumes from their checkpoint
    (["--engine", "mesh"], "runs"),
    # the numerics policy (queue A item 6) is ported: the bf16 preset runs
    (["--numerics", "bf16"], None),
    # the overlapped exchange (A4) is ported: it runs, with a top-k wire
    (["--exchange-delay", "1", "--exchange-compression", "topk"], "runs"),
    # ... and top-k without the delay is the reference's usage error
    (["--exchange-compression", "topk"], "usage"),
    # ... and so does the im2col route's GEMM in bf16 (A6b)
    (["--numerics", "bf16", "--conv-backend", "im2col_ref"], None),
])
def test_cli_refuses_what_is_not_ported(extra, match, tmp_path, capfd):
    if match == "runs":
        ck, a, b = (str(tmp_path / n) for n in ("ck", "a.jsonl", "b.jsonl"))
        train_cli.main(CLI + ["--steps", "2", "--ckpt-dir", ck,
                              "--ckpt-every", "2", "--metrics-out", a]
                       + extra)
        header = capfd.readouterr().out.splitlines()[0]
        engine = "mesh backend=gloo" if "mesh" in extra else "reference"
        assert f"engine={engine} " in header
        losses = [r["loss"] for r in read_jsonl(a, "train")]
        assert len(losses) == 2 and all(map(math.isfinite, losses))
        # the one-process engine picks the run up at step 2
        flags = [f for f in extra if f not in ("--engine", "mesh")]
        res = train_cli.main(CLI + ["--steps", "3", "--ckpt-dir", ck,
                                    "--resume", "--metrics-out", b] + flags)
        assert (res.start_step, res.final_step) == (2, 3)
        if "mesh" in extra:
            # the two ranks' losses are the one-process engine's
            c = str(tmp_path / "c.jsonl")
            train_cli.main(CLI + ["--steps", "2", "--metrics-out", c])
            assert [r["loss"] for r in read_jsonl(c, "train")] == losses
        return
    if match == "usage":
        with pytest.raises(ValueError) as want:
            jax_pa.ExchangeConfig(compression="topk")
        with pytest.raises(SystemExit):
            train_cli.main(CLI + ["--steps", "1"] + extra)
        assert str(want.value) in capfd.readouterr().err
        return
    if match is None:
        res = train_cli.main(CLI + ["--steps", "2"] + extra)
        assert res.final_step == 2
        assert all(math.isfinite(v) for _, v in res.losses)
        assert {x.dtype for x in tree_leaves(res.state.params)} == \
            {torch.bfloat16}
        assert {x.dtype for x in tree_leaves(
            res.state.opt_state["master"])} == {torch.float32}
        assert float(res.state.numerics["scale"]) == 2.0 ** 15
        return
    with pytest.raises(NotImplementedError, match=match):
        train_cli.main(CLI + ["--steps", "1"] + extra)


def _cli(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], capture_output=True, text=True, env=env,
                          timeout=300)


def test_cli_trains_on_the_cpu_and_needs_cuda_otherwise():
    base = ["--arch", "alexnet", "--smoke", "--steps", "2", "--batch", "8",
            "--replicas", "2"]
    proc = _cli(base + ["--device", "cpu"])
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("arch=alexnet-smoke replicas=2")
    assert lines[-1].startswith("done: steps 0 -> 2")
    assert "replica spread 0.00e+00" in lines[-1]
    if not torch.cuda.is_available():
        proc = _cli(base)
        assert proc.returncode != 0
        assert "CUDA is not available" in proc.stderr
