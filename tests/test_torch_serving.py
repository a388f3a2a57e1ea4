"""The port's serving engine against the reference's, on the same weights
and images: conv-family classification through the admission fixpoint,
one class id per image, no decode ticks.  Sampled streams use
``torch.Generator`` and cannot match ``jax.random``: they are checked for
determinism and for the top-k support only."""
import dataclasses
import os
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro import models as jax_models
from repro.configs import ALEXNET_FAITHFUL_SMOKE as JAX_CFG
from repro.kernels.common import KernelPolicy as JaxPolicy
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch import models, weights
from repro_torch.configs import ALEXNET_FAITHFUL_SMOKE as CFG
from repro_torch.configs import ARCHS, reduced
from repro_torch.launch import serve as serve_cli
from repro_torch.serving import Request, ServingEngine, sample

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _images(cfg, n, seed=0):
    rs = np.random.default_rng(seed)
    return [rs.standard_normal((cfg.image_size, cfg.image_size,
                                cfg.in_channels)) for _ in range(n)]


def _model(seed=0):
    return models.init(CFG, torch.Generator().manual_seed(seed),
                       device="cpu")


def test_engine_matches_reference_engine():
    """10 images through 4 slots in both packages: the same greedy class
    per rid, one token each, no decode ticks, pow-2 buckets."""
    jcfg = dataclasses.replace(JAX_CFG, kernels=JaxPolicy(backend="xla"))
    params = jax_models.init(jax.random.PRNGKey(0), jcfg)
    imgs = _images(CFG, 10)
    ref = JaxEngine(params, jcfg, slots=4, capacity=32)
    want = {r.rid: r.tokens for r in
            ref.run([JaxRequest(image=im) for im in imgs])}

    model = weights.from_reference(jax.tree.map(np.asarray, params), CFG,
                                   device="cpu")
    eng = ServingEngine(model, CFG, slots=4)
    results = eng.run([Request(image=im) for im in imgs])
    assert len(results) == 10
    assert {r.rid: r.tokens for r in results} == want
    assert eng.decode_steps == 0 and ref.decode_steps == 0
    assert eng._buckets_used == ref._buckets_used
    assert eng._buckets_used <= {("img", 1), ("img", 2), ("img", 4)}
    for r in results:
        assert r.prompt_len == 0 and len(r.tokens) == 1
        assert r.t_first >= r.t_submit and r.t_done >= r.t_first


def test_engine_rejects_bad_images():
    eng = ServingEngine(_model(), CFG, slots=2)
    with pytest.raises(ValueError, match="image of shape"):
        eng.submit(Request(image=np.zeros((3, 3, 3))))
    with pytest.raises(ValueError, match="image of shape"):
        eng.submit(Request(prompt=[1, 2, 3]))      # tokens are not images
    assert eng.load() == {"free_slots": 2, "queue_len": 0, "active": 0,
                          "draining": False}


def test_second_wave_reuses_slots():
    eng = ServingEngine(_model(), CFG, slots=2)
    first = eng.run([Request(image=im) for im in _images(CFG, 2, seed=1)])
    second = eng.run([Request(image=im) for im in _images(CFG, 3, seed=2)])
    assert len(first) == 2 and len(second) == 3
    assert [r.rid for r in second] == [2, 3, 4]
    assert eng._results == {}             # retired results are pruned
    assert eng._active == [None, None]    # every slot retired
    assert eng.free_slots == 2 and eng.queue_len == 0


def test_temperature_sampling_is_deterministic_per_seed():
    model = _model()
    imgs = _images(CFG, 6, seed=3)

    def run(seed):
        eng = ServingEngine(model, CFG, slots=4, temperature=5.0, seed=seed)
        return [r.tokens for r in eng.run([Request(image=im)
                                           for im in imgs])]

    assert run(7) == run(7)


def test_top_k_never_leaves_the_top_k():
    model = _model()
    imgs = _images(CFG, 8, seed=4)
    with torch.no_grad():
        logits = model(torch.from_numpy(np.stack(imgs).astype(np.float32)))
    top2 = torch.topk(logits, 2, dim=-1).indices
    for seed in range(3):
        eng = ServingEngine(model, CFG, slots=4, temperature=10.0, top_k=2,
                            seed=seed)
        for r in eng.run([Request(image=im) for im in imgs]):
            assert r.tokens[0] in top2[r.rid].tolist()


def test_sample_greedy_takes_the_first_maximum():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    assert sample(logits).tolist() == [1, 0]


def test_sample_top_k_support_and_generator():
    torch.manual_seed(0)
    logits = torch.randn(4, 50)
    top = torch.topk(logits, 3, dim=-1).indices
    draws = [sample(logits, 2.0, 3, torch.Generator().manual_seed(s))
             for s in range(20)]
    for d in draws:
        for row in range(4):
            assert d[row].item() in top[row].tolist()
    again = sample(logits, 2.0, 3, torch.Generator().manual_seed(0))
    assert torch.equal(draws[0], again)
    with pytest.raises(ValueError, match="needs a generator"):
        sample(logits, 1.0)


@pytest.mark.parametrize("family", ["moe", "vlm", "encdec"])
def test_engine_serves_the_conv_family_only(family):
    """conv and the dense, moe, ssm and hybrid LMs serve (a reduced
    mixtral-8x7b engine builds its ring); a family not ported yet still
    raises, naming its ROADMAP item."""
    if family == "moe":
        cfg = reduced(ARCHS["mixtral-8x7b"], 2, 64)
        params = models.init(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        eng = ServingEngine(params, cfg, slots=2, capacity=16)
        assert eng.state.cache["blocks"][0]["k"].shape[:3] == (2, 2, 16)
        return
    cfg = types.SimpleNamespace(family=family, name=f"a-{family}-arch")
    with pytest.raises(NotImplementedError, match="queue A item 8"):
        ServingEngine(_model(), cfg)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-9b"])
def test_block_pool_refuses_recurrent_state(arch):
    """The block pool holds attention K/V only: the engine and the serve
    CLI refuse ``block_size > 0`` for ssm and hybrid with a ValueError, as
    the reference's engine refuses it (dense and moe only)."""
    cfg = reduced(ARCHS[arch], 3, 64)
    params = models.init(cfg, torch.Generator().manual_seed(0),
                         device="cpu")
    with pytest.raises(ValueError, match="pure-attention family"):
        ServingEngine(params, cfg, capacity=32, block_size=8)
    with pytest.raises(ValueError, match="pure-attention family"):
        serve_cli.main(["--arch", arch, "--smoke", "--layers", "3",
                        "--device", "cpu", "--block-size", "8"])


@pytest.mark.parametrize("arch,layers", [("rwkv6-7b", 2),
                                         ("recurrentgemma-9b", 4)])
def test_cli_serves_the_recurrent_lms_on_the_cpu(arch, layers, capsys):
    """``--arch rwkv6-7b`` / ``recurrentgemma-9b --smoke --device cpu``
    serve every request and end in ``serve OK``, at 4 decode ticks per
    dispatch."""
    serve_cli.main(["--arch", arch, "--smoke", "--layers", str(layers),
                    "--device", "cpu", "--requests", "5", "--slots", "2",
                    "--max-new", "6", "--ticks-per-dispatch", "4"])
    out = capsys.readouterr().out
    assert f"family={ARCHS[arch].family}" in out
    assert "served 5 requests / 30 tokens" in out
    assert out.strip().splitlines()[-1] == "serve OK"


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        capture_output=True, text=True, env=env, timeout=300)


def test_cli_serves_on_the_cpu_when_asked():
    proc = _cli("--arch", "alexnet", "--smoke", "--device", "cpu",
                "--requests", "5", "--slots", "2")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "serve OK"
    assert "served 5 requests / 5 tokens" in proc.stdout
    assert "0 decode ticks" in proc.stdout


def test_cli_refuses_to_fall_back_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is available")
    proc = _cli("--arch", "alexnet", "--smoke", "--requests", "1")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "serve OK" not in proc.stdout
