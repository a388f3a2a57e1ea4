"""The port's router over real worker processes (``python -m
repro_torch.launch.serve --role ... --device cpu``): a burst spreads over
the instances, disaggregated prefill gives the colocated streams, a drain
hands live rows to the peer with no request dropped and the same tokens,
a draining instance refuses admissions, and a worker that dies has its
requests placed again on a peer.

The streams are held against the engine the workers build (the serve
CLI's ``build_cfg`` and ``build_engine`` on the same flags) run in this
process; ``tests/test_torch_tier.py`` holds that engine's handoffs
against the reference.  The module shares one tier (2 engines and a
prefill worker) across its tests, and the death test starts 2 more; every
worker runs one thread, and every handle is shut down in ``finally``.
"""
import time

import numpy as np
import pytest

from repro_torch.launch import serve as serve_cli
from repro_torch.serving import Request, Router
from repro_torch.serving.tier import spawn_worker

ARGV = ["--arch", "olmo-1b", "--smoke", "--layers", "2", "--d-model", "64",
        "--slots", "2", "--capacity", "48", "--device", "cpu"]
ENV = {"OMP_NUM_THREADS": "1"}
TIMEOUT = 120


def _reqs(n=6, new=16, seed=3, short=False):
    """``n`` random prompts of 4 to 19 tokens (4 to 8 if ``short``, which
    leaves room in the ring of 48 for 40 new tokens)."""
    rng = np.random.default_rng(seed)
    hi = 9 if short else 20
    return [Request(prompt=rng.integers(0, 512, size=int(rng.integers(4, hi))),
                    max_new_tokens=new) for _ in range(n)]


def _streams(results, reqs):
    """{prompt: tokens}; the router's global rids follow submission."""
    return {tuple(reqs[r["grid"]].prompt.tolist()): r["tokens"]
            for r in results}


def _single_process(reqs):
    """What the tier must emit: the workers' engine, in this process."""
    args = serve_cli.build_parser().parse_args(ARGV)
    cfg = serve_cli.build_cfg(args, pytest.fail)
    eng = serve_cli.build_engine(args, cfg, "cpu", pytest.fail)
    rids = {eng.submit(Request(prompt=q.prompt,
                               max_new_tokens=q.max_new_tokens)): q
            for q in reqs}
    return {tuple(rids[r.rid].prompt.tolist()): r.tokens for r in eng.run()}


def _spawn(names, role="engine"):
    return [spawn_worker(role, ARGV, env=ENV, name=n) for n in names]


def _shutdown(handles):
    for h in handles:
        h.shutdown(timeout=10)


@pytest.fixture(scope="module")
def tier():
    """(2 engine handles, a prefill handle), connected."""
    insts = _spawn(["eng0", "eng1"])
    pre = _spawn(["pre"], role="prefill")[0]
    try:
        for h in insts + [pre]:
            h.connect(timeout=TIMEOUT)
        yield insts, pre
    finally:
        _shutdown(insts + [pre])


def test_burst_spreads_over_instances(tier):
    """8 requests into two 2-slot instances land on both: least-loaded
    placement reads fresh stats at every placement."""
    insts, _ = tier
    r = Router(insts)
    reqs = _reqs(n=8, new=8, seed=11)
    for q in reqs:
        r.submit(q)
    res = r.run_until_done(timeout=TIMEOUT)
    assert len(res) == 8
    assert _streams(res, reqs) == _single_process(reqs)
    st = r.stats()["instances"]
    stepped = [n for n, s in st.items() if s["decode_steps"] > 0]
    assert len(stepped) == 2, f"one instance starved: {st}"


def test_disaggregated_prefill_gives_the_colocated_streams(tier):
    """Through the prefill worker, the decode instances admit snapshots
    only, and every stream equals the single-process engine's."""
    insts, pre = tier
    r = Router(insts, prefill=pre)
    reqs = _reqs(seed=5)
    for q in reqs:
        r.submit(q)
    res = r.run_until_done(timeout=TIMEOUT)
    assert _streams(res, reqs) == _single_process(reqs)
    assert r.prefill_worker is pre          # no fallback to colocated
    assert pre.call("stats")[1]["prefills"] == len(reqs)


def test_drain_hands_live_rows_to_the_peer(tier):
    """Drain an instance mid-stream: its rows replay into the peer, every
    request finishes with the single-process engine's tokens, and the
    drained instance answers submits with 'draining'."""
    insts, _ = tier
    r = Router(insts)
    reqs = _reqs(new=40, short=True)
    steps = insts[0].call("stats")[1]["decode_steps"]
    for q in reqs:
        r.submit(q)
    deadline = time.monotonic() + TIMEOUT
    while insts[0].call("stats")[1]["decode_steps"] < steps + 2:
        assert time.monotonic() < deadline
        time.sleep(0.005)
    rows, _ = r.drain_instance(insts[0], timeout=TIMEOUT)
    assert rows > 0, "the drain found no row mid-stream"
    res = r.run_until_done(timeout=TIMEOUT)
    assert len(res) == len(reqs)             # none dropped
    assert _streams(res, reqs) == _single_process(reqs)
    status, _ = insts[0].call("submit", {"prompt": [1, 2],
                                         "max_new_tokens": 2, "rid": 99})
    assert status == "draining"
    assert insts[0].call("stats")[1]["draining"]


def test_instance_death_places_its_requests_on_the_peer():
    """Kill a worker mid-request: the router marks it dead and restarts
    its requests on the peer (at-least-once); every request finishes with
    the single-process engine's tokens."""
    insts = _spawn(["mort0", "mort1"])
    try:
        for h in insts:
            h.connect(timeout=TIMEOUT)
        r = Router(insts)
        reqs = _reqs()
        for q in reqs:
            r.submit(q)
        time.sleep(0.3)
        insts[0].proc.kill()
        res = r.run_until_done(timeout=TIMEOUT)
        assert len(res) == len(reqs)
        assert _streams(res, reqs) == _single_process(reqs)
        assert r.stats()["dead"] == ["mort0"]
    finally:
        _shutdown(insts)


class _FakeInstance:
    """An engine worker's answers, scripted: ``free`` slots, and
    ``defer`` injects answered 'defer' before one is taken."""

    def __init__(self, free, defer=0):
        self.name, self.dead = "fake", False
        self.free, self.defer, self.injected = free, defer, []

    def call(self, cmd, payload=None):
        if cmd == "stats":
            return "ok", {"free_slots": self.free, "queue_len": 0,
                          "draining": False, "step_times": []}
        if cmd == "poll":
            return "ok", []
        assert cmd == "inject", cmd
        if self.defer:
            self.defer -= 1
            return "defer", None
        self.free -= 1
        self.injected.append(payload)
        return "ok", len(self.injected) - 1


class _FakePrefill:
    def __init__(self):
        self.prefills = 0

    def call(self, cmd, payload=None):
        assert cmd == "prefill", cmd
        self.prefills += 1
        return "ok", f"snapshot {self.prefills}".encode()


def test_disaggregated_router_prefills_a_deferred_prompt_again():
    """As the reference's router does: a snapshot that no instance takes
    is dropped, the prompt stays at the head of the pending queue, and
    each retry prefills it again until an inject is taken."""
    inst, pre = _FakeInstance(free=0, defer=1), _FakePrefill()
    r = Router([inst], prefill=pre)
    r.submit({"prompt": [1, 2], "max_new_tokens": 2})
    assert pre.prefills == 1 and inst.injected == []     # no free slot
    inst.free = 1
    r.pump()        # prefilled again; the inject is deferred
    assert pre.prefills == 2 and inst.injected == [] and r.deferred == 1
    r.pump()
    assert pre.prefills == 3 and inst.injected == [b"snapshot 3"]
    assert r.outstanding() == 1 and not r._pending
