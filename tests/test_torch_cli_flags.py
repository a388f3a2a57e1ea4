"""The port's CLIs take every flag the reference's CLIs take, and the split
of the bf16 dk/dv kernel over a group's query heads.

The reference builds its train parser inside ``main()``, so its flags are
read from the source with ``ast``; the serve flags come from
``repro.launch.serve.build_parser()``.  Each flag parses in the port's
``build_parser()`` at the reference's default; each value the port does not
run yet raises ``NotImplementedError`` naming its ROADMAP item, and the
values it does run pass its checks.  The tier's flags reach the workers
through ``worker_argv``, and one disaggregated tier runs on the CPU.
"""
import argparse
import ast
import dataclasses
import re
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.flash_attention import ops
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli

try:
    from repro.launch import serve as ref_serve
except ImportError:      # a GPU host without JAX runs only the cuda tests
    ref_serve = None

ROOT = Path(__file__).resolve().parents[1]
H100_SMS = 132           # H100 SXM


def _train_flags():
    """(option strings, default, store_true) of every ``add_argument`` in
    the reference's train CLI."""
    tree = ast.parse((ROOT / "src/repro/launch/train.py").read_text())
    flags = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            flag = kw.get("action")
            flags.append((tuple(a.value for a in node.args),
                          ast.literal_eval(kw["default"]) if "default" in kw
                          else None,
                          isinstance(flag, ast.Constant)
                          and flag.value == "store_true"))
    return flags


def _serve_flags():
    if ref_serve is None:
        return []
    return [(tuple(a.option_strings), a.default,
             isinstance(a, argparse._StoreTrueAction))
            for a in ref_serve.build_parser()._actions
            if a.option_strings and a.dest != "help"]


TRAIN_FLAGS = _train_flags()
SERVE_FLAGS = _serve_flags()


def _accepts(parser, names, default, store_true):
    """Every spelling of the flag parses, at the reference's default."""
    for name in names:
        action = parser._option_string_actions.get(name)
        assert action is not None, f"{name} is not a flag of the port"
        if store_true:
            assert getattr(parser.parse_args([]), action.dest) is False
            assert getattr(parser.parse_args([name]), action.dest) is True
        elif default is not None:
            args = parser.parse_args([name, str(default)])
            assert getattr(args, action.dest) == default
        else:
            assert action.default is None or action.default == \
                parser.parse_args([]).__dict__[action.dest]


def test_the_reference_flags_were_found():
    names = {n for names, _, _ in TRAIN_FLAGS for n in names}
    assert {"--replica-exec", "--topk-frac", "--kv-cache-dtype",
            "--numerics"} <= names
    assert len(TRAIN_FLAGS) > 30
    assert ref_serve is None or len(SERVE_FLAGS) > 20


@pytest.mark.parametrize("names,default,store_true", TRAIN_FLAGS,
                         ids=[f[0][0] for f in TRAIN_FLAGS])
def test_train_cli_takes_the_reference_flag(names, default, store_true):
    _accepts(train_cli.build_parser(), names, default, store_true)


@pytest.mark.parametrize("names,default,store_true", SERVE_FLAGS,
                         ids=[f[0][0] for f in SERVE_FLAGS])
def test_serve_cli_takes_the_reference_flag(names, default, store_true):
    _accepts(serve_cli.build_parser(), names, default, store_true)


@pytest.mark.parametrize("extra", [
    ["--replica-exec", "vmap"], ["--replica-exec", "scan"],
    ["--topk-frac", "0.5"], ["--kv-cache-dtype", "int8"],
])
def test_train_cli_runs_these_values(extra):
    """The port's replicas run one after another under either
    --replica-exec; --topk-frac and --kv-cache-dtype pass the checks."""
    args = train_cli.build_parser().parse_args(
        ["--arch", "olmo-1b", "--smoke"] + extra)
    train_cli.check_ported(args)
    cfg = train_cli.build_cfg(args, pytest.fail)
    assert cfg.numerics.kv_cache_dtype == args.kv_cache_dtype


@pytest.mark.parametrize("extra,item", [
    # the numerics policy (queue A item 6) is ported: the bf16 preset runs
    (["--numerics", "bf16"], None),
    (["--images"], "queue A item 8"),
    # speculative decoding (queue A item 10) is ported: these run
    (["--draft-arch", "olmo-1b"], None),
    (["--draft-layers", "1"], None),
    (["--spec-tokens", "2", "--draft-layers", "1"], None),
], ids=lambda x: " ".join(x) if isinstance(x, list) else str(x))
def test_serve_cli_names_the_item_of_what_it_does_not_run(extra, item,
                                                          capsys):
    argv = ["--smoke", "--device", "cpu"] + extra
    if item is None:
        serve_cli.main(argv + ["--requests", "2", "--max-new", "4",
                               "--prompt-len", "8", "--capacity", "32"])
        out = capsys.readouterr().out.splitlines()
        assert out[-1] == "serve OK"
        spec = any(a.startswith("--draft") for a in extra)
        assert spec == any(line.startswith("spec: ") and "draft tokens "
                           "accepted" in line for line in out)
        if "--numerics" in extra:
            assert "dtype=bfloat16" in out[0]
            assert "numerics=param=bfloat16,master_fp32," in out[0]
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        serve_cli.main(argv)


@pytest.mark.parametrize("numerics", ["fp32", "bf16"])
def test_serve_cli_dtype_sets_only_the_param_dtype(numerics):
    """``--dtype`` is the numerics policy's ``param_dtype`` and nothing
    else: the config's own ``dtype`` and every other policy field stay
    the preset's."""
    from repro_torch.configs import ARCHS
    from repro_torch.numerics import get_policy, param_dtype

    base = ["--arch", "olmo-1b", "--numerics", numerics]
    args = serve_cli.build_parser().parse_args(base + ["--dtype", "float32"])
    cfg = serve_cli.build_cfg(args, pytest.fail)
    assert cfg.dtype == ARCHS["olmo-1b"].dtype == "bfloat16"
    assert cfg.numerics == dataclasses.replace(get_policy(numerics),
                                               param_dtype="float32")
    assert param_dtype(cfg) == torch.float32
    plain = serve_cli.build_cfg(serve_cli.build_parser().parse_args(base),
                                pytest.fail)
    assert plain.numerics == get_policy(numerics)
    assert param_dtype(plain) == torch.bfloat16


def test_serve_cli_defaults_pass_the_checks():
    serve_cli.check_ported(serve_cli.build_parser().parse_args([]))


# the flags a worker must share with the process that spawns it
WORKER_FLAGS = ("arch", "smoke", "layers", "d_model", "slots", "capacity",
                "temperature", "top_k", "ticks_per_dispatch",
                "kernel_backend", "numerics", "kv_cache_dtype", "seed",
                "device", "dtype", "max_queue")


@pytest.mark.parametrize("extra,dest,value", [
    (["--tier", "2"], "tier", 2),
    (["--instances", "2"], "tier", 2),
    (["--disagg"], "disagg", True),
    (["--role", "engine"], "role", "engine"),
    (["--port", "5000"], "port", 5000),
    (["--max-queue", "4"], "max_queue", 4),
], ids=lambda x: " ".join(x) if isinstance(x, list) else str(x))
def test_serve_cli_takes_the_tier_flags(extra, dest, value):
    """The tier's flags pass the checks (queue A item 11 is ported), and
    ``worker_argv`` hands a worker every flag that shapes the engine, the
    worker's --max-queue among them; --tier and --disagg stay with the
    spawning process, --role, --port and --port-fd come from
    ``spawn_worker``."""
    ap = serve_cli.build_parser()
    args = ap.parse_args(["--smoke", "--device", "cpu", "--layers", "3",
                          "--d-model", "64", "--dtype", "float32",
                          "--temperature", "0.5", "--top-k", "4",
                          "--kv-cache-dtype", "int8", "--seed", "7"] + extra)
    serve_cli.check_ported(args)
    assert getattr(args, dest) == value
    argv = serve_cli.worker_argv(args)
    worker = ap.parse_args(["--role", "engine", "--port", "1"] + argv)
    for flag in WORKER_FLAGS:
        assert getattr(worker, flag) == getattr(args, flag), flag
    assert not {"--tier", "--disagg", "--role", "--port",
                "--port-fd"} & set(argv)


def test_serve_cli_runs_a_disaggregated_tier(capsys, monkeypatch):
    """``--tier 2 --disagg``: two engine workers and a prefill worker
    behind the router serve every request and end in ``serve OK``."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # the workers inherit it
    serve_cli.main(["--smoke", "--device", "cpu", "--tier", "2",
                    "--disagg", "--requests", "4", "--max-new", "4",
                    "--capacity", "48"])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "serve OK"
    assert any(line.startswith("served 4 requests / 16 tokens")
               and "dead=none" in line for line in out)


def _heads(group, n_split, split):
    """The query heads split ``split`` of ``n_split`` takes in the bf16
    dk/dv kernel (``flash_dkv_sm90.cu``): [z G / n, (z + 1) G / n)."""
    return range(split * group // n_split, (split + 1) * group // n_split)


SPLIT_SHAPES = [  # (B, Hkv, S, G, hd)
    (4, 16, 2048, 1, 128),      # olmo-1b training
    (2, 1, 2048, 16, 256),      # recurrentgemma-9b attn layers
    (1, 8, 1000, 4, 128),       # GQA, ragged S
    (1, 1, 333, 16, 256),
    (1, 2, 517, 8, 64),
    (1, 2, 130, 3, 64),         # G not a power of two
    (1, 1, 64, 6, 128),
    (8, 8, 4096, 2, 128),       # a full grid: no split
]


@pytest.mark.parametrize("b,hkv,s,g,hd", SPLIT_SHAPES, ids=str)
def test_dkv_split_covers_each_query_head_once(b, hkv, s, g, hd):
    n = ops.dkv_split(b, hkv, s, g, hd, H100_SMS)
    assert 1 <= n <= g
    heads = [h for z in range(n) for h in _heads(g, n, z)]
    assert sorted(heads) == list(range(g))          # each pair exactly once
    assert all(len(_heads(g, n, z)) for z in range(n))
    blocks = b * hkv * -(-s // ops.DKV_ROWS[hd])
    if n < g:                   # stops splitting once the card is full
        assert blocks * n >= 2 * H100_SMS


@pytest.mark.parametrize("b,hkv,s,hd", [(4, 16, 2048, 128), (1, 1, 64, 64),
                                        (2, 1, 2048, 256), (1, 4, 7, 128)])
def test_dkv_split_is_one_without_a_group(b, hkv, s, hd):
    assert ops.dkv_split(b, hkv, s, 1, hd, H100_SMS) == 1


def test_dkv_split_fills_the_card_at_the_hybrid_shape():
    """MQA, G 16, hd 256: 64 blocks without a split, 512 with it."""
    assert ops.dkv_split(2, 1, 2048, 16, 256, H100_SMS) == 8


def test_dkv_split_fills_a_smaller_card_with_fewer_splits():
    """The split follows the card's SM count: half the SMs, half the
    blocks needed."""
    assert ops.dkv_split(2, 1, 2048, 16, 256, H100_SMS // 2) == 4


def test_dkv_rows_match_the_kernel_source():
    """``ops.DKV_ROWS`` is the bf16 dk/dv kernel's KV rows per block:
    ``Layout::BK`` of ``flash_dkv_sm90.cu`` at the warpgroup count its
    dispatch picks for each head dim."""
    src = (ROOT / "src/repro_torch/kernels/flash_attention/csrc/"
           "flash_dkv_sm90.cu").read_text()
    per_wg = re.search(r"int BK = NWG \* (\d+);", src)
    assert per_wg, "Layout::BK is no longer NWG * rows"
    picks = {}
    for hd, nwg in re.findall(r"case (\d+):\s*e = DKV_PASS\(\1, (\d+),",
                              src):
        assert picks.setdefault(int(hd), int(nwg)) == int(nwg)
    assert sorted(picks) == sorted(ops.DKV_ROWS) == list(ops.HEAD_DIMS)
    assert ops.DKV_ROWS == {hd: nwg * int(per_wg.group(1))
                            for hd, nwg in picks.items()}
