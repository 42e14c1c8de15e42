"""The schedule driver's launch plan (parallel/device_loop.schedule_device
binding every in-loop kernel once a schedule: ops/loop_kernels bind_<name>,
ops/sweep_kernel bind_sweep_round_loop) and the block timer's event pool
(util.Tracer). On the CPU: the plan's outputs equal those of the kernels
checked and launched anew at every call, the convergence skip's carries,
the counters, the bind-time checks, and that nothing a schedule returns is
shared with the next. On the card (marked cuda, skipped without one): the
same equality with the launch counts, the pooled events against fresh
ones, and the pool's size over 100 schedules.

    python -m pytest tests/test_torch_launch_plan.py -m cuda   # the card

This file imports neither jax nor pangene_tpu."""
import io

import numpy as np
import pytest
import torch

from pangene_tpu_torch import pipeline, util
from pangene_tpu_torch.ops import loop_kernels as lk
from pangene_tpu_torch.ops import sweep_kernel as sk
from pangene_tpu_torch.options import PgOpt
from pangene_tpu_torch.parallel import device_loop as dl
from pangene_tpu_torch.parallel import mesh as M
from pangene_tpu_torch.testing import synth_paf_files

torch.set_num_threads(1)

CPU = M.local(torch.device("cpu"))


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """pack_host's Pack of a small corpus's graph after phase 1 (on the
    host; the card tests upload it too). Its schedule skips the branch
    block in its last rounds and the sweep and walk from one round
    earlier."""
    files = synth_paf_files(str(tmp_path_factory.mktemp("launch_plan")),
                            n_genome=6, n_gene=200, n_iso=3, seed=23)
    packs = []
    orig = dl.pack_host
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PANGENE_PARSE_WORKERS", "1")
        mp.setattr(dl, "pack_host", lambda *a, **kw:
                   packs.append(orig(*a, **kw)) or packs[-1])
        util.verbose = 0
        try:
            pipeline.run(PgOpt(engine="sharded", device="cpu"), files,
                         out=io.StringIO())
        finally:
            util.verbose = 3
    assert dl.LAST["engaged"] is True and len(packs) == 1
    return packs[0]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def unplanned(mp):
    """Every binding of the loop replaced by one whose launch checks and
    binds the whole argument list anew at each call, as the kernels' public
    wrappers do (new outputs every call): the schedule as the wrappers,
    called one by one, run it."""
    def anew(name, call):
        bind = getattr(lk, "bind_" + name)

        def bound(*b, **kw):
            return lk.Bound(lambda *a: call(bind, b, kw, a),
                            bind(*b, **kw).out)
        mp.setattr(lk, "bind_" + name, bound)

    anew("branch_prep", lambda bind, b, kw, a: bind(
        *b[:6], a[0], *b[7:], **kw).launch(a[0]))
    anew("branch_block", lambda bind, b, kw, a: bind(*a[:7], **kw).launch(
        *a[:7], torch.zeros_like(a[7])))
    anew("prop_round", lambda bind, b, kw, a: bind(
        *b[:4], *a[:5], **kw).launch(*a))
    anew("occ_round", lambda bind, b, kw, a: bind(
        *b[:5], *a[:2], *b[7:13], a[2], **dict(kw, n_grp=a[4])).launch(*a))
    anew("walk_pairs", lambda bind, b, kw, a: bind(*b, **kw).launch())
    anew("merge_fold", lambda bind, b, kw, a: bind(
        a[0], a[1], **dict(kw, perm=a[3], full=a[4] if a[4:] else None)
        ).launch(a[0], a[1], torch.empty_like(a[2]), *a[3:]))
    sweep = sk.bind_sweep_round_loop
    mp.setattr(sk, "bind_sweep_round_loop", lambda *b, **kw: sk.Bound(
        lambda: sweep(*b, **kw).launch()))


def schedule(pk, mesh, stats=None, inputs=None, cfg=None):
    """schedule_device on the Pack's inputs uploaded to `mesh`'s device;
    returns its 20 outputs."""
    inputs = pk.inputs if inputs is None else inputs
    N = dl.N_DEVICE_INPUTS
    on_dev = [M.put_sharded(a, mesh, 1) for a in inputs[:5]] \
        + [torch.from_numpy(np.array(a)).to(mesh.device)
           for a in inputs[5:N]]
    return dl.schedule_device(*on_dev, *inputs[N:-1], bool(inputs[-1]),
                              cfg=cfg or pk.cfg, stats=stats, mesh=mesh)


def counts():
    return ({k: dict(c) for k, c in lk.n_calls.items()},
            dict(sk.n_fused["loop"]))


def assert_same(got, want):
    assert len(got) == len(want) == 20
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.cpu(), b.cpu()
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.equal(a, b), i


def test_plan_equals_the_wrappers_called_one_by_one(packed, monkeypatch):
    got = schedule(packed, CPU)
    with monkeypatch.context() as mp:
        unplanned(mp)
        want = schedule(packed, CPU)
    assert_same(got, want)
    # and the numpy entry (its own upload) gives them too
    for a, b in zip(dl.schedule(*packed.inputs, cfg=packed.cfg,
                                device="cpu"), got):
        assert np.array_equal(a, b.numpy())


def test_skipped_rounds_carry_their_counts(packed):
    """A round that skips the branch block (convergence) logs the counts
    of the last round that ran it, one that skips the walk the arc count
    of the last merge, both rows written once by the plan's launches."""
    logs = schedule(packed, CPU)[14].numpy()
    ran_br, ran_sw = logs[:, 8], logs[:, 9]
    assert 0 < ran_br.sum() < len(logs) - 1 and 0 < ran_sw.sum() < len(logs)
    last_br = last_sw = None
    for r, row in enumerate(logs):
        if ran_br[r]:
            last_br = r
        elif last_br is not None:
            assert np.array_equal(row[0:2], logs[last_br, 0:2]), r
        else:
            assert not row[0:2].any(), r
        if ran_sw[r]:
            last_sw = r
        else:
            assert row[7] == logs[last_sw, 7], r


def test_checks_do_not_grow_with_the_rounds(packed):
    """At world 1 the plan checks each kernel once a schedule: as many
    checks for R rounds as for one; every in-loop launch goes through the
    plan (the tail's walk and fold are the checked wrappers')."""
    stats: dict = {}
    before = counts()
    schedule(packed, CPU, stats)
    after = counts()
    plain = {k: after[0][k]["plain"] - before[0][k]["plain"]
             for k in lk.n_calls if k != "merge_fold_full"}
    sweeps = after[1]["plain"] - before[1]["plain"]
    assert stats["bound_launches"] == sum(plain.values()) + sweeps - 2
    one: dict = {}
    inputs = [a[:1] if 11 <= i < 18 else a
              for i, a in enumerate(packed.inputs)]
    schedule(packed, CPU, one, inputs, packed.cfg._replace(R=1))
    R = packed.cfg.R
    assert R > 1 and stats["launch_checks"] == one["launch_checks"] > 0
    assert one["bound_launches"] < stats["bound_launches"]
    assert stats["host_syncs"] == R and one["host_syncs"] == 1


def test_plan_raises_at_bind_time(packed):
    """A plane of the wrong shape, dtype or device raises before round 0,
    with no kernel run; so do the bindings on their own."""
    inputs = list(packed.inputs)
    inputs[7] = inputs[7][:-1]                 # arc0_vw one short
    before = counts()
    with pytest.raises(ValueError, match="arc_s1"):
        schedule(packed, CPU, {}, inputs)
    assert counts() == before
    G, H, A, S = 2, 8, 5, 3
    u8 = lambda *s: torch.zeros(s, dtype=torch.uint8)
    i32 = lambda *s: torch.zeros(s, dtype=torch.int32)
    ok = lambda *s: torch.zeros(s, dtype=torch.bool)
    word = torch.zeros(2, dtype=torch.int64)
    prop = [u8(G, H), u8(G, H), ok(G, H), i32(G, H), i32(G, 2 * H),
            i32(G, H), ok(G, H), u8(A), word]
    lk.bind_prop_round(*prop)
    for pos, bad in ((0, i32(G, H)), (4, i32(G, H)),
                     (7, u8(A).to("meta"))):
        with pytest.raises(ValueError):
            lk.bind_prop_round(*(prop[:pos] + [bad] + prop[pos + 1:]))
    logs = torch.zeros((4, 10), dtype=torch.int64)
    occ = [ok(S), u8(G, H), ok(G, H), i32(G, H), i32(7),
           torch.zeros(A, dtype=torch.int64), i32(S), i32(S, 2), logs,
           u8(4, S), i32(4, S, 2), i32(4, S, 2), i32(4, S), word]
    lk.bind_occ_round(*occ, B=4)
    for pos, bad in ((8, logs[:, :9]), (3, torch.zeros((G, H)))):
        with pytest.raises(ValueError):
            lk.bind_occ_round(*(occ[:pos] + [bad] + occ[pos + 1:]), B=4)
    with pytest.raises(ValueError, match="n_grp"):
        lk.bind_occ_round(*occ, B=4, n_grp=i32(A + 1))


def test_successive_schedules_share_no_storage(packed):
    first = schedule(packed, CPU)
    second = schedule(packed, CPU)
    kept = [t.clone() for t in second]
    ptrs = lambda outs: {t.untyped_storage().data_ptr() for t in outs
                         if t.numel()}
    assert not ptrs(first) & ptrs(second)
    for t in first:
        t.fill_(1)
    assert_same(second, kept)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def card(cuda_device):
    return M.local(cuda_device)


@pytest.mark.cuda
def test_card_plan_equals_the_wrappers(packed, cuda_device, monkeypatch):
    """On the card the plan gives the 20 outputs of the wrappers called
    one by one, with the same launches of every kernel; every in-loop
    launch goes through the plan."""
    mesh = card(cuda_device)
    schedule(packed, mesh, {})                   # builds the kernels
    planned: dict = {}
    got = schedule(packed, mesh, planned)
    unplanned_stats: dict = {}
    with monkeypatch.context() as mp:
        unplanned(mp)
        want = schedule(packed, mesh, unplanned_stats)
    torch.cuda.synchronize()
    assert_same(got, want)
    for k in ("loop_launches", "sweep_launches", "host_syncs"):
        assert planned[k] == unplanned_stats[k], k
    loop = planned["loop_launches"]
    assert planned["bound_launches"] == sum(
        v for k, v in loop.items() if k != "merge_fold_full") \
        + planned["sweep_launches"] - 2
    assert planned["launch_checks"] < unplanned_stats["launch_checks"]
    for a, b in zip(dl.schedule(*packed.inputs, cfg=packed.cfg,
                                device="cpu"), got):
        assert np.array_equal(a, b.cpu().numpy())


class Paired(util.Tracer):
    """The tracer with a fresh pair of events recorded just inside each
    block's pooled pair, on the same stream, each pair's two starts (and
    two ends) queued behind a spin of the device's (torch.cuda._sleep), so
    that the host's time between two records does not show."""
    made: list = []
    SPIN = 4_000_000                  # cycles: ~2 ms, past any host gap

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.fresh, self._fresh_open, self.pairs = [], [], []
        Paired.made.append(self)

    def begin(self, name, key=None):
        start = end = None
        if key is not None and self.cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            self.fresh.append((key, start, end))
            torch.cuda._sleep(self.SPIN)
        super().begin(name, key)
        if start is not None:
            start.record(self._stream)
        self._fresh_open.append(end)

    def end(self):
        end = self._fresh_open.pop()
        if end is not None:
            torch.cuda._sleep(self.SPIN)
            end.record(self._stream)
        super().end()

    def block_ms(self, keys):
        if self.cuda:
            torch.cuda.synchronize()
            self.pairs = [(k, s.elapsed_time(e), fs.elapsed_time(fe))
                          for (k, s, e), (_, fs, fe)
                          in zip(self._events, self.fresh)]
        return super().block_ms(keys)


def back_to_back_ms(n: int = 20) -> float:
    """The most two events recorded back to back behind a spin read apart
    on this card: the events' resolution where the device waits for no
    host."""
    worst = 0.0
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(Paired.SPIN)
        a.record()
        b.record()
        b.synchronize()
        worst = max(worst, a.elapsed_time(b))
    return worst


@pytest.mark.cuda
def test_card_pooled_events_time_the_blocks(packed, cuda_device,
                                            monkeypatch):
    """block_ms from the pooled events: the blocks' keys, and each block's
    time that of a fresh pair of events just inside it, within the events'
    resolution: twice (a start and an end) what two records back to back
    read apart, and 5 us more."""
    mesh = card(cuda_device)
    schedule(packed, mesh, {})
    resolution = back_to_back_ms()
    Paired.made = []
    monkeypatch.setattr(util, "Tracer", Paired)
    stats: dict = {}
    schedule(packed, mesh, stats)
    (tr,) = [t for t in Paired.made if t.cuda]
    assert set(stats["block_ms"]) == set(dl.BLOCKS)
    assert len(tr.pairs) == len(tr.fresh) > len(dl.BLOCKS)
    for key, pooled, fresh in tr.pairs:
        assert fresh > 1.0 and \
            -0.001 <= pooled - fresh <= 2 * resolution + 0.005, \
            (key, pooled, fresh, resolution)
    for key in dl.BLOCKS:
        assert stats["block_ms"][key] == pytest.approx(
            sum(p for k, p, _ in tr.pairs if k == key), abs=2e-3)


@pytest.mark.cuda
def test_card_event_pool_does_not_grow(packed, cuda_device):
    """100 schedules take their blocks' events from the pool and give them
    all back: it holds the same events after the first as after the
    last."""
    mesh = card(cuda_device)
    schedule(packed, mesh, {})
    pool = util.event_pool(torch.cuda.current_device())
    size, ids = len(pool), {id(e) for e in pool}
    assert size > 2 * len(dl.BLOCKS)
    for _ in range(100):
        schedule(packed, mesh, {})
    assert len(pool) == size and {id(e) for e in pool} == ids
