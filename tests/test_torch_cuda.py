"""Tests of the port that need the card: K1/K2 (f32 and bf16 pools) and K3
against their plain versions on CUDA tensors, and a few train steps on the
card against the CPU from one carried state (DeepFM f32, multislot bf16
with stochastic rounding); the block path (a block against sequential
steps, the asynchronous block's launch counts, the staged buffers'
events); K1/K2 at the streaming push's and the delta restore's shapes, a
ServingModel on the card against the CPU, a checkpoint round trip and a
streaming push on the card. They skip without CUDA. On a machine with a card (and no
JAX) run them with:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

TF32 is turned off for the matrix products, so the card's dense tower runs
in full f32 like the CPU's.
"""

import numpy as np
import pytest
import torch

from monolith_tpu_torch import convert
from monolith_tpu_torch.data.synthetic import SyntheticCTR, SyntheticMultiSlot
from monolith_tpu_torch.embedding.engine import EngineConfig
from monolith_tpu_torch.models.deepfm import DeepFMTask
from monolith_tpu_torch.models.multislot import MultiSlotTask
from monolith_tpu_torch.ops import rounding
from monolith_tpu_torch.ops import scatter as ops
from monolith_tpu_torch.training.trainer import Trainer, TrainerConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


#: row counts around one tile (T rows) and one ring (S stages) of a width
EDGE_COUNTS = {"T-1": lambda t, s: t - 1, "T": lambda t, s: t,
               "T+1": lambda t, s: t + 1, "S*T+1": lambda t, s: s * t + 1}


def _n_of(n, row_bytes):
    """A row count given as a number or as a key of EDGE_COUNTS."""
    if isinstance(n, int):
        return n
    tile_rows, _ = ops.tile_geometry(row_bytes)
    return EDGE_COUNTS[n](tile_rows, ops.STAGES)


@pytest.mark.parametrize("rows_kind", ["mixed", "all_minus_one",
                                       "none_minus_one", "beyond_cap"])
@pytest.mark.parametrize("n,width,dtype", [
    (1, 128, torch.float32), (1000, 128, torch.float32),
    (4097, 128, torch.float32), (300, 4, torch.float32),
    (300, 256, torch.float32), (1000, 128, torch.bfloat16),
    (4097, 128, torch.bfloat16), (300, 8, torch.bfloat16),
    # around one tile and one ring, in both pool types
    ("T-1", 128, torch.float32), ("T", 128, torch.float32),
    ("T+1", 128, torch.float32), ("S*T+1", 128, torch.float32),
    ("T-1", 128, torch.bfloat16), ("T", 128, torch.bfloat16),
    ("T+1", 128, torch.bfloat16), ("S*T+1", 128, torch.bfloat16),
    # more tiles than the grid's warps have stages: every stage wraps at
    # least twice (132 blocks x 8 warps x 3 stages x 32 rows = 101,376)
    (200_000, 128, torch.float32), (250_000, 128, torch.bfloat16),
    # 16-, 1024- and 2048-byte rows
    (5000, 4, torch.float32), (5000, 8, torch.bfloat16),
    (5000, 256, torch.float32), (5000, 512, torch.bfloat16),
    (5000, 512, torch.float32), (5000, 1024, torch.bfloat16)])
def test_kernels_match_plain_on_card(card, n, width, dtype, rows_kind):
    row_bytes = width * torch.empty((), dtype=dtype).element_size()
    n = _n_of(n, row_bytes)
    g = torch.Generator(device=card).manual_seed(n)
    cap = 1 << 18
    pool = torch.randn((cap, width), generator=g, device=card).to(dtype)
    rows = torch.randperm(cap, generator=g, device=card)[:n].to(torch.int32)
    if rows_kind == "mixed":
        rows[::3] = -1
    elif rows_kind == "all_minus_one":
        rows[:] = -1
    elif rows_kind == "beyond_cap":
        rows[::2] += cap
        rows[1::7] = -1
    values = torch.randn((n, width), generator=g, device=card).to(dtype)
    before = ops.gather_rows.launches, ops.scatter_rows.launches
    out = ops.gather_rows(pool, rows)
    assert torch.equal(out, ops.gather_rows_plain(pool, rows))
    a, b = pool.clone(), pool.clone()
    ops.scatter_rows(a, rows, values)
    ops.scatter_rows_plain(b, rows, values)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert (ops.gather_rows.launches, ops.scatter_rows.launches) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("row_bytes", [16, 32, 256, 512, 1024, 2048])
@pytest.mark.parametrize("n", [1, 1000, 49152, 1_000_000])
def test_python_geometry_mirrors_the_kernels(card, n, row_bytes):
    """ops/scatter.py's arithmetic (the CPU tests' subject) is what
    csrc/rows.cu launches with."""
    got = ops.kernel_geometry(n, row_bytes)
    tile_rows, smem = ops.tile_geometry(row_bytes)
    assert (got["warps"], got["stages"], got["tile_rows"],
            got["smem_bytes"]) == (ops.WARPS, ops.STAGES, tile_rows, smem)
    assert got["blocks_per_sm"] >= 1
    grid = ops.grid_size(n, tile_rows, got["blocks_per_sm"], got["sms"])
    assert got["gather_grid"] == grid
    # K2's kernel may fit another number of blocks an SM than K1's
    assert 1 <= got["scatter_grid"] <= -(-(-(-n // tile_rows)) // ops.WARPS)


def test_card_steps_match_cpu(card):
    def make(device):
        return Trainer(DeepFMTask(capacity_per_shard=4096, hidden=(32, 16),
                                  init_scale=0.0),
                       TrainerConfig(engine=EngineConfig(unique_cap=512,
                                                         new_cap=512),
                                     log_every=0), device=device)

    data = SyntheticCTR(num_users=400, num_items=300, batch_size=64, seed=2)
    batches = [data.batch() for _ in range(5)]
    cpu = make("cpu")
    for i in range(2):
        cpu.train_step(*batches[i], ts=i)
    gpu = make(card)
    convert.load_state(gpu, convert.export_state(cpu))
    for i in range(2, 5):
        lc = cpu.train_step(*batches[i], ts=i)["loss"].item()
        lg = gpu.train_step(*batches[i], ts=i)["loss"].item()
        # the card's index_add backward uses atomics: order varies
        np.testing.assert_allclose(lg, lc, rtol=1e-4)


@pytest.mark.parametrize("shape", [(1,), (3,), (4,), (4099,), (49152, 128),
                                   (7, 33)])
def test_stochastic_round_matches_plain_on_card(card, shape):
    g = torch.Generator(device=card).manual_seed(len(shape))
    x = torch.randn(shape, generator=g, device=card) * 10
    before = rounding.stochastic_round_bf16.launches
    out = rounding.stochastic_round_bf16(x, 123456789012345)
    ref = rounding.stochastic_round_bf16_plain(x, 123456789012345)
    torch.cuda.synchronize()
    assert rounding.stochastic_round_bf16.launches == before + 1
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))
    # the card's plain version draws the CPU's noise
    cpu = rounding.stochastic_round_bf16(x.cpu(), 123456789012345)
    assert torch.equal(out.cpu().view(torch.int16), cpu.view(torch.int16))


def test_multislot_bf16_card_steps_match_cpu(card):
    """bf16 pools with stochastic rounding and an f32 tower, init_scale=0.0
    (the card's and the CPU's generators draw different init): the kernels
    draw the plain versions' bits, but the pooling backward's atomics
    change gradient bits, which can flip a rounding; losses agree to rtol
    1e-3. (A bf16 tower adds the card's own bf16 rounding of the matrix
    products; chip_smoke.py holds that case to rtol 1e-3 too.)"""
    def make(device):
        return Trainer(MultiSlotTask(
            num_tables=4, num_slots=10, embedding_dim=8,
            capacity_per_shard=8192, history_length=6, hidden=(32,),
            merge=True, init_scale=0.0, table_dtype=torch.bfloat16,
            stochastic_rounding=True),
            TrainerConfig(engine=EngineConfig(unique_cap=2048, new_cap=2048),
                          log_every=0), device=device)

    data = SyntheticMultiSlot(num_slots=10, vocab_per_slot=300,
                              history_length=6, batch_size=256, seed=2)
    batches = [data.batch() for _ in range(5)]
    cpu = make("cpu")
    for i in range(2):
        cpu.train_step(*batches[i], ts=i)
    gpu = make(card)
    convert.load_state(gpu, convert.export_state(cpu))
    for i in range(2, 5):
        lc = cpu.train_step(*batches[i], ts=i)["loss"].item()
        lg = gpu.train_step(*batches[i], ts=i)["loss"].item()
        np.testing.assert_allclose(lg, lc, rtol=1e-3)


# ----------------------------------------------------------------------
# block dispatch on the card
# ----------------------------------------------------------------------

def _small_deepfm(device, cls=Trainer, **engine):
    return cls(DeepFMTask(capacity_per_shard=4096, hidden=(32, 16),
                              init_scale=0.0),
                   TrainerConfig(engine=EngineConfig(
                       unique_cap=512, new_cap=512, **engine),
                       clip_norm=0.05, log_every=0), device=device)


@pytest.mark.parametrize("stale", [False, True], ids=["sync", "async"])
def test_card_block_matches_sequential_steps(card, stale):
    """A block of 4 on the card against 4 train_steps on the card from one
    carried state. The pooling backward's atomics sum in a varying order,
    so not bit for bit: losses rtol 1e-4, pool atol 1e-5. (The
    asynchronous block is compared on ids that no two consecutive steps
    share: only then does it compute what the sequential steps do.)"""
    if stale:
        rng = np.random.default_rng(3)
        batches = []
        for k in range(5):
            ids = np.arange(100 * k, 100 * k + 60)
            batches.append((
                {"user_id": rng.choice(ids, (64, 1)).astype(np.int64),
                 "item_id": rng.choice(ids, (64, 1)).astype(np.int64),
                 "hist_items": rng.choice(ids, (64, 10)).astype(np.int64)},
                {"label": rng.integers(0, 2, 64).astype(np.float32)}))
    else:
        data = SyntheticCTR(num_users=400, num_items=300, batch_size=64,
                            seed=2)
        batches = [data.batch() for _ in range(5)]
    seq, blk = _small_deepfm(card), _small_deepfm(card, async_optimize=stale)
    seq.train_step(*batches[0], ts=0)
    # the training step's one-time graph capture synchronises: blk takes
    # it here, outside the guarded block; the state is then seq's
    blk.train_step(*batches[0], ts=0)
    convert.load_state(blk, convert.export_state(seq))
    ls = [seq.train_step(*b, ts=1)["loss"].item() for b in batches[1:]]
    torch.cuda.set_sync_debug_mode("error")
    try:  # a synchronisation inside the block raises
        out = blk.train_step_block(batches[1:], staged=blk.stage_block(
            batches[1:], ts=1))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    np.testing.assert_allclose(out["loss"].cpu().numpy(), ls, rtol=1e-4)
    np.testing.assert_allclose(
        blk.table_states["sparse"]["data"].cpu().numpy(),
        seq.table_states["sparse"]["data"].cpu().numpy(), atol=1e-5, rtol=0)


def test_async_block_launch_counts(card):
    """K steps of the 1-step-stale block: 2K gathers (stale and fresh), K
    scatters (none at the first step, which has no pending write-back; the
    last step's at the end of the block), and K roundings for a bf16 pool
    with stochastic rounding."""
    from monolith_tpu_torch import ops as port_ops
    tr = Trainer(MultiSlotTask(
        num_tables=4, num_slots=10, embedding_dim=8, capacity_per_shard=8192,
        history_length=6, hidden=(32,), merge=True,
        table_dtype=torch.bfloat16, stochastic_rounding=True),
        TrainerConfig(engine=EngineConfig(unique_cap=2048, new_cap=2048,
                                          async_optimize=True),
                      log_every=0), device=card)
    data = SyntheticMultiSlot(num_slots=10, vocab_per_slot=300,
                              history_length=6, batch_size=256, seed=2)
    batches = [data.batch() for _ in range(6)]
    port_ops.reset_launch_counts()
    tr.train_step(*batches[0])
    assert port_ops.launch_counts() == {
        "gather_rows": 1, "scatter_rows": 1, "stochastic_round_bf16": 1}
    port_ops.reset_launch_counts()
    out = tr.train_step_block(batches[1:])
    assert port_ops.launch_counts() == {
        "gather_rows": 10, "scatter_rows": 5, "stochastic_round_bf16": 5}
    assert torch.isfinite(out["loss"]).all() and tr.step == 6


@pytest.mark.parametrize("stale", [False, True], ids=["sync", "async"])
def test_overlapped_block_equals_the_serial_pack_on_the_card(card, stale):
    """Two staged blocks of 8 whose steps 1..7 the stage worker packs,
    step 5's pack slowed so that its row is sent after a wait, against a
    trainer that packs every step on the calling thread: the device wires
    and the stats equal bit for bit, each host store's map too; no
    synchronisation inside a block; losses rtol 1e-4 and pool atol 1e-5
    (the pooling backward's atomics)."""
    import threading
    import time

    class Serial(Trainer):
        def _stage_overlaps(self):
            return False
    data = SyntheticCTR(num_users=400, num_items=300, batch_size=256,
                        seed=4)
    batches = [data.batch() for _ in range(17)]
    over = _small_deepfm(card, async_optimize=stale)
    serial = Serial(over.task, over.config, device=card)
    main, real = threading.get_ident(), over._pack_full_wire

    def slowed(fid_batch, batch, layout, ts, stepno, out):
        if stepno % 8 == 5 and threading.get_ident() != main:
            time.sleep(0.05)
        return real(fid_batch, batch, layout, ts, stepno, out)
    over._pack_full_wire = slowed
    outs = {}
    for name, tr in (("over", over), ("serial", serial)):
        tr.train_step(*batches[0], ts=3)
        got = []
        for blk in range(2):
            pairs = batches[1 + 8 * blk:9 + 8 * blk]
            staged = tr.stage_block(pairs, ts=4 + blk)
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = tr.train_step_block(pairs, staged=staged)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            got.append((staged["wires"].cpu(), out))
        outs[name] = got
    for (wa, oa), (wb, ob) in zip(outs["over"], outs["serial"]):
        assert torch.equal(wa, wb)
        assert oa["stats"] == ob["stats"]
        np.testing.assert_allclose(oa["loss"].cpu().numpy(),
                                   ob["loss"].cpu().numpy(), rtol=1e-4)
    for t in over.engine.tables:
        for x, y in zip(over.engine.store_of(t).save(),
                        serial.engine.store_of(t).save()):
            np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(
        over.table_states["sparse"]["data"].cpu().numpy(),
        serial.table_states["sparse"]["data"].cpu().numpy(), atol=1e-5,
        rtol=0)


# ----------------------------------------------------------------------
# the training step's captured graphs (training/graphs.py)
# ----------------------------------------------------------------------

class _Eager(Trainer):
    def _graph_capable(self):
        return False


def _graph_pair(card, model, stale, n):
    """(graphed trainer, eager trainer, n batches) of the small DeepFM or
    of DLRM-DCNv2 at portbench/tests/small_dcnv2.py's widths (26 tables,
    C21 on the wide wire), both from one seed."""
    if model == "deepfm":
        data = SyntheticCTR(num_users=400, num_items=300, batch_size=64,
                            seed=2)
        return (_small_deepfm(card, async_optimize=stale),
                _small_deepfm(card, _Eager, async_optimize=stale),
                [data.batch() for _ in range(n)])
    from portbench.models import dlrm_dcnv2
    from portbench.streams import criteo_multihot
    from portbench.tests import small_dcnv2
    cfg = small_dcnv2.files()["cfg"]
    caps = tuple(sorted(cfg["unique_caps"].items()))
    top = max(dict(caps).values())
    trainers = [cls(dlrm_dcnv2.build_task(cfg), TrainerConfig(
        engine=EngineConfig(unique_cap=top, new_cap=top, unique_caps=caps,
                            new_caps=caps, async_optimize=stale),
        seed=5, log_every=0), device=card) for cls in (Trainer, _Eager)]
    world = criteo_multihot.World(cfg, (1 << 35) + 7)
    return (*trainers, [world.batch(i, cfg["batch_size"]) for i in range(n)])


@pytest.mark.parametrize("stale", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("model", ["deepfm", "dcnv2"])
def test_graphed_block_matches_the_eager_block(card, model, stale):
    """Step 0 (eager: the capture's own step) and a staged block of 8 that
    replays, against a trainer whose `_graph_capable` is False, from one
    seed: losses rtol 1e-4, rows and dense parameters atol 1e-5 (the
    pooling backward's atomics sum in a varying order). The graphed block
    runs under the synchronisation check and counts 8 replays and no
    eager step; its 8 rows of predictions differ from one another (what
    the block stacks is no replay's static buffer)."""
    from monolith_tpu_torch.utils import tracing
    graphed, eager, batches = _graph_pair(card, model, stale, 9)
    outs = {}
    for name, tr in (("graphed", graphed), ("eager", eager)):
        with tracing.recording() as rec:
            first = tr.train_step(*batches[0], ts=1)
        assert rec.counter_totals().get("graph.capture", (0,))[0] == (
            name == "graphed")
        staged = tr.stage_block(batches[1:], ts=2)
        with tracing.recording() as rec:
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = tr.train_step_block(batches[1:], staged=staged)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        graph = {k: v[0] for k, v in rec.counter_totals().items()
                 if k.startswith("graph.")}
        assert graph == ({"graph.replay": 8} if name == "graphed" else {})
        outs[name] = (first, out)
    (gf, go), (ef, eo) = outs["graphed"], outs["eager"]
    np.testing.assert_allclose(gf["loss"].item(), ef["loss"].item(),
                               rtol=1e-4)
    np.testing.assert_allclose(go["loss"].cpu().numpy(),
                               eo["loss"].cpu().numpy(), rtol=1e-4)
    np.testing.assert_allclose(go["preds"].cpu().numpy(),
                               eo["preds"].cpu().numpy(), atol=1e-5)
    preds = go["preds"]
    assert all(not torch.equal(preds[i], preds[j])
               for i in range(8) for j in range(i))
    for t in graphed.table_states:
        for a, b in zip(torch.utils._pytree.tree_leaves(
                graphed.table_states[t]),
                torch.utils._pytree.tree_leaves(eager.table_states[t])):
            np.testing.assert_allclose(a.float().cpu().numpy(),
                                       b.float().cpu().numpy(), atol=1e-5,
                                       rtol=0, err_msg=t)
    for (n, p), (_, q) in zip(graphed.module.named_parameters(),
                              eager.module.named_parameters()):
        np.testing.assert_allclose(p.detach().cpu().numpy(),
                                   q.detach().cpu().numpy(), atol=1e-5,
                                   rtol=0, err_msg=n)


def test_graphs_replay_the_captured_shapes_only(card):
    """A capture at step 0; a block of 4 replays 4 times; a step and a
    block of another batch size run eager; the first size replays again."""
    from monolith_tpu_torch.utils import tracing
    tr = _small_deepfm(card)
    big = SyntheticCTR(num_users=400, num_items=300, batch_size=64, seed=2)
    small = SyntheticCTR(num_users=400, num_items=300, batch_size=48, seed=3)
    with tracing.recording() as rec:
        tr.train_step(*big.batch(), ts=1)
        tr.train_step_block([big.batch() for _ in range(4)], ts=1)
        tr.train_step(*small.batch(), ts=1)
        tr.train_step_block([small.batch() for _ in range(4)], ts=1)
        out = tr.train_step(*big.batch(), ts=1)
    got = [(c.name, c.step) for c in rec.counters
           if c.name in ("graph.replay", "graph.eager")]
    assert got == ([("graph.eager", 0)]
                   + [("graph.replay", s) for s in range(1, 5)]
                   + [("graph.eager", s) for s in range(5, 10)]
                   + [("graph.replay", 10)])
    (capture,) = [c for c in rec.counters if c.name == "graph.capture"]
    assert capture.step == 0 and capture.value > 0
    assert torch.isfinite(out["loss"])


def test_staged_buffer_is_refilled_only_after_its_copys_event(card):
    """Two pinned buffers per (layout, K), used in turn: staging block n+2
    refills the buffer block n was sent from, and `host()` waits for that
    block's copies' event first (recorded after each row's copy, the
    stage worker filling rows 1..K-1 while the block dispatches). The
    device copy of block n keeps its content."""
    data = SyntheticCTR(num_users=400, num_items=300, batch_size=64, seed=2)
    batches = [data.batch() for _ in range(9)]
    tr = _small_deepfm(card)
    tr.train_step(*batches[0])
    a = tr.stage_block(batches[1:5])
    key = (a["layout"], 4, tr._full_wire_words(a["layout"]))
    staging = tr._wires[key]
    assert all(b.is_pinned() for b in staging.bufs)
    assert staging.events[0] is not None and staging.events[1] is None
    tr.train_step_block(batches[1:5], staged=a)
    sent = staging.bufs[0].clone()
    b = tr.stage_block(batches[5:9])
    assert staging.events[1] is not None and staging.i == 0
    tr.train_step_block(batches[5:9], staged=b)
    first_event = staging.events[0]
    host = staging.host()               # waits for block a's copy
    assert first_event.query()
    assert host.ctypes.data == staging.bufs[0].data_ptr()
    # block a's device copy still holds what was sent
    assert torch.equal(a["wires"].cpu(), sent)


# ----------------------------------------------------------------------
# the shapes K1/K2 meet outside a train step: the streaming push, deltas
# ----------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,live", [(512, 1), (512, 300), (1024, 513),
                                    (4096, 2049), (4096, 4096),
                                    (1 << 15, 21_300), (1 << 18, 140_685),
                                    (1 << 20, 608_846)])
def test_gather_at_the_streaming_shapes(card, n, live, dtype):
    """sync_now gathers at a power-of-two length with a -1 tail: from a
    round after one full-width step (2^15) up to a first round that drains
    every id since the trainer's first step (2^20)."""
    g = torch.Generator(device=card).manual_seed(n + live)
    cap = max(1 << 16, 2 * n)
    pool = torch.randn((cap, 128), generator=g, device=card).to(dtype)
    rows = torch.full((n,), -1, dtype=torch.int32, device=card)
    rows[:live] = torch.randperm(cap, generator=g, device=card)[:live].int()
    out = ops.gather_rows(pool, rows)
    assert torch.equal(out, ops.gather_rows_plain(pool, rows))
    assert not out[live:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 7, 33, 1000, 40_001, 294_838, 400_003,
                               504_203])
def test_assign_rows_at_the_delta_shapes(card, n, dtype):
    """restore_delta's rows: any length (not a multiple of the tile), -1
    where the store refused an id. K1, the overwrite of the params columns
    and K2 on the card equal the plain versions on the CPU."""
    from monolith_tpu_torch.embedding import table as table_lib
    spec = DeepFMTask(capacity_per_shard=1 << 19,
                      table_dtype=dtype).tables()[0]
    g = torch.Generator().manual_seed(n)
    base = torch.randn((spec.capacity_per_shard, 128), generator=g).to(dtype)
    rows = torch.randperm(spec.capacity_per_shard, generator=g)[:n].int()
    rows[::5] = -1
    values = torch.randn((n, spec.dim), generator=g)
    cpu, gpu = {"data": base.clone()}, {"data": base.to(card)}
    before = ops.gather_rows.launches, ops.scatter_rows.launches
    table_lib.assign_rows(spec, gpu, rows.to(card), values.to(card))
    table_lib.assign_rows(spec, cpu, rows, values)
    assert (ops.gather_rows.launches, ops.scatter_rows.launches) == \
        (before[0] + 1, before[1] + 1)
    assert torch.equal(gpu["data"].cpu(), cpu["data"])


def _serving_fixture(tmp_path, device, **task_kw):
    from monolith_tpu_torch.serving import export_model
    task = DeepFMTask(embedding_dim=8, capacity_per_shard=4096,
                      hidden=(16, 8), **task_kw)
    tr = Trainer(task, TrainerConfig(engine=EngineConfig(
        unique_cap=512, new_cap=512, record_touch=True), log_every=0,
        seed=51), device=device)
    data = SyntheticCTR(num_users=80, num_items=40, batch_size=128, seed=51)
    for _ in range(10):
        tr.train_step(*data.batch())
    return task, tr, data, export_model(tr, str(tmp_path))


def test_serving_model_card_matches_cpu(card, tmp_path):
    """One export served from the card and from the CPU: predictions rtol
    1e-5, row lookups exact; the default device is the card."""
    from monolith_tpu_torch.serving import ServingModel
    task, tr, data, path = _serving_fixture(tmp_path, "cpu")
    gpu = ServingModel(task, path, unique_cap=512)
    cpu = ServingModel(task, path, unique_cap=512, device="cpu")
    assert gpu.device.type == "cuda" and gpu.pools["sparse"].is_cuda
    before = ops.gather_rows.launches
    for _ in range(3):
        fb, b = data.batch()
        np.testing.assert_allclose(gpu.predict(fb, b), cpu.predict(fb, b),
                                   rtol=1e-5)
    assert ops.gather_rows.launches == before   # serving runs no kernel
    fids = tr.engine.stores["sparse"].save()[0]
    np.testing.assert_array_equal(gpu.lookup_rows("sparse", fids),
                                  cpu.lookup_rows("sparse", fids))
    push = np.arange(5000, 5040, dtype=np.int64)
    vals = np.random.default_rng(0).normal(size=(40, 9)).astype(np.float32)
    assert gpu.apply_delta("sparse", push, vals) == 40
    np.testing.assert_array_equal(gpu.lookup_rows("sparse", push), vals)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_checkpoint_round_trip_on_the_card(card, tmp_path, dtype):
    """save -> restore on the card is bit-exact; a delta then carries the
    rows touched since (K1 to save; K1 and K2 to restore)."""
    from monolith_tpu_torch.training import checkpoint
    kw = dict(table_dtype=dtype, stochastic_rounding=dtype == torch.bfloat16)
    task, a, data, _ = _serving_fixture(tmp_path / "x", card, **kw)
    checkpoint.save(a, str(tmp_path))
    _, b, _, _ = _serving_fixture(tmp_path / "y", card, **kw)
    b.train_step(*data.batch())                # diverge, then restore
    assert checkpoint.restore(b, str(tmp_path)) == 10
    assert b.table_states["sparse"]["data"].is_cuda
    assert torch.equal(a.table_states["sparse"]["data"],
                       b.table_states["sparse"]["data"])
    for (n, p), (_, q) in zip(a.module.named_parameters(),
                              b.module.named_parameters()):
        assert torch.equal(p, q), n
        assert torch.equal(a.opt_state[n], b.opt_state[n]), n
    for _ in range(2):
        a.train_step(*data.batch(), ts=10 ** 9)
    before = ops.gather_rows.launches, ops.scatter_rows.launches
    path = checkpoint.save_delta(a, str(tmp_path), since_ts=10 ** 9)
    applied = checkpoint.restore_delta(b, path)
    assert (ops.gather_rows.launches, ops.scatter_rows.launches) == \
        (before[0] + 2, before[1] + 1)
    fids = np.load(path + "/sparse-s0.npz")["fids"]
    assert applied == len(fids) > 0
    spec = task.tables()[0]
    from monolith_tpu_torch.embedding import table as table_lib
    rows = [torch.from_numpy(t.engine.stores["sparse"].lookup(fids)).to(card)
            for t in (a, b)]
    assert torch.equal(
        table_lib.lookup(spec, a.table_states["sparse"], rows[0]),
        table_lib.lookup(spec, b.table_states["sparse"], rows[1]))


def test_streaming_push_on_the_card(card, tmp_path):
    """sync_now gathers the touched rows with K1 at a padded length and
    the serving pool on the card then holds the trainer's rows."""
    from monolith_tpu_torch.serving import ServingModel
    from monolith_tpu_torch.training.streaming import (StreamingConfig,
                                                       StreamingTrainer)
    task, tr, data, path = _serving_fixture(tmp_path, card)
    model = ServingModel(task, path, unique_cap=512)

    class Sync:
        pushes = []

        def push(self, table, fids, values):
            self.pushes.append(fids)
            return model.apply_delta(table, fids, values)

    st = StreamingTrainer(tr, Sync(), StreamingConfig(sync_interval_steps=4))
    before = ops.gather_rows.launches
    res = st.run(iter(data), max_steps=8)
    assert res["sync_rounds"] == 3 and len(Sync.pushes) == 2
    assert ops.gather_rows.launches == before + 8 + 2
    fids = np.unique(np.concatenate(Sync.pushes))
    from monolith_tpu_torch.embedding import table as table_lib
    rows = torch.from_numpy(tr.engine.stores["sparse"].lookup(fids)).to(card)
    want = table_lib.lookup(task.tables()[0], tr.table_states["sparse"], rows)
    np.testing.assert_array_equal(model.lookup_rows("sparse", fids),
                                  want.cpu().numpy())


# ----------------------------------------------------------------------
# expiry and tiered storage
# ----------------------------------------------------------------------

def _ids_batch(ids, label=1.0):
    ids = np.asarray(ids, np.int64)[:, None]
    return ({"user_id": ids, "item_id": ids + 10_000,
             "hist_items": np.full((len(ids), 10), -1, np.int64)},
            {"label": np.full(len(ids), label, np.float32)})


@pytest.mark.parametrize("n", [1, 5, 1000, 4097])
def test_zero_rows_is_one_k2_of_zeros_and_no_k3_on_a_bf16_pool(card, n):
    """zero_rows on a bf16 pool with stochastic rounding: exactly one K2
    launch and no K3; the freed rows read zero, every other row keeps its
    bits (held against the plain version on a copy)."""
    from monolith_tpu_torch import ops as port_ops
    tr = Trainer(MultiSlotTask(
        num_tables=2, num_slots=4, embedding_dim=8, capacity_per_shard=8192,
        history_length=6, hidden=(16,), merge=True,
        table_dtype=torch.bfloat16, stochastic_rounding=True),
        TrainerConfig(engine=EngineConfig(unique_cap=512, new_cap=512),
                      log_every=0), device=card)
    (tname, state), = tr.table_states.items()
    pool = state["data"]
    g = torch.Generator(device=card).manual_seed(n)
    pool.copy_(torch.randn(pool.shape, generator=g, device=card))
    rows = np.random.default_rng(n).choice(pool.shape[0], n, replace=False)
    expect = pool.clone()
    ops.scatter_rows_plain(expect, torch.from_numpy(rows.astype(np.int32)
                                                    ).to(card),
                           torch.zeros((n, pool.shape[1]), dtype=pool.dtype,
                                       device=card))
    port_ops.reset_launch_counts()
    tr.engine.zero_rows(tr.table_states, {tname: rows.astype(np.int64)})
    assert port_ops.launch_counts() == {
        "gather_rows": 0, "scatter_rows": 1, "stochastic_round_bf16": 0}
    assert pool.dtype == torch.bfloat16
    assert torch.equal(pool.view(torch.int16), expect.view(torch.int16))


def _tiered_deepfm(device, capacity=256):
    return Trainer(DeepFMTask(embedding_dim=8, capacity_per_shard=capacity,
                              hidden=(16,), ttl_seconds=3600,
                              init_scale=0.0),
                   TrainerConfig(engine=EngineConfig(
                       unique_cap=256, new_cap=256, tiered=True),
                       log_every=0), device=device)


def test_spill_is_one_k1_a_table_and_archives_the_plain_gather(card):
    """spill_expired: one K1 gather a table (of just the expired rows, padded
    to a power of two) and one zeroing K2; the archived values equal the
    plain version's gather of those rows, bit for bit."""
    from monolith_tpu_torch import ops as port_ops
    tr = _tiered_deepfm(card)
    for ts in (100, 101):
        tr.train_step(*_ids_batch(np.arange(1, 40)), ts=ts)
    fids, rows, _, _ = tr.engine.stores["sparse"].save()
    plain = ops.gather_rows_plain(
        tr.table_states["sparse"]["data"],
        torch.from_numpy(rows.astype(np.int32)).to(card))[:, :17].cpu()
    port_ops.reset_launch_counts()
    assert tr.spill_expired(200) == {"sparse": len(fids)}
    assert port_ops.launch_counts() == {
        "gather_rows": 1, "scatter_rows": 1, "stochastic_round_bf16": 0}
    ok, vals = tr.engine.archives["sparse"].revive(fids)
    assert ok.all()
    assert np.array_equal(vals, plain.numpy())
    assert not tr.table_states["sparse"]["data"][
        torch.from_numpy(rows).long().to(card)].any()


def test_tiered_card_steps_match_cpu(card):
    """From one state: train, spill, other ids, revive, train on the card
    and on the CPU: losses rtol 1e-4, pools atol 1e-5, archives, stores and
    counters equal."""
    cpu = _tiered_deepfm("cpu")
    gpu = _tiered_deepfm(card)
    convert.load_state(gpu, convert.export_state(cpu))
    a, b = _ids_batch(np.arange(1, 33)), _ids_batch(np.arange(100, 132))
    schedule = [("step", a, 100), ("step", a, 101), ("spill", None, 200),
                ("step", b, 300), ("step", a, 400), ("step", a, 500)]
    for what, pair, ts in schedule:
        if what == "spill":
            assert cpu.spill_expired(ts) == gpu.spill_expired(ts)
            continue
        lc = cpu.train_step(*pair, ts=ts)["loss"].item()
        lg = gpu.train_step(*pair, ts=ts)["loss"].item()
        np.testing.assert_allclose(lg, lc, rtol=1e-4)
    sc, sg = convert.export_state(cpu), convert.export_state(gpu)
    for x, y in zip(sc["stores"]["sparse"], sg["stores"]["sparse"]):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_allclose(sg["tables"]["sparse"], sc["tables"]["sparse"],
                               atol=1e-5, rtol=0)
    ac, ag = convert.export_archives(cpu), convert.export_archives(gpu)
    for k in ("fids", "rows", "map_tss", "tss", "spilled", "revived",
              "dropped"):
        np.testing.assert_array_equal(ag["sparse"][k], ac["sparse"][k])
    np.testing.assert_allclose(ag["sparse"]["values"],
                               ac["sparse"]["values"], atol=1e-5, rtol=0)
    assert gpu.engine.archives["sparse"].revived == 64


# ----------------------------------------------------------------------
# the multi-array step and the structure-of-arrays state
# ----------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(49152, 17), (13, 17), (135_168, 128)])
def test_stochastic_round_at_the_multi_array_shapes(card, shape):
    """K3 on a structure-of-arrays table's concatenated [U, 17] params (no
    whole 16-byte vector a row; [13, 17] leaves a ragged tail) and on the
    packed rows of a step above 65535 unique ids."""
    g = torch.Generator(device=card).manual_seed(shape[0])
    x = torch.randn(shape, generator=g, device=card)
    out = rounding.stochastic_round_bf16(x, 0xFEDCBA9876543210)
    ref = rounding.stochastic_round_bf16_plain(x, 0xFEDCBA9876543210)
    torch.cuda.synchronize()
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))


# ----------------------------------------------------------------------
# K3's persistent grid: octets a trip, 16-byte stores, the tail
# ----------------------------------------------------------------------

#: element counts: around a group (4) and an octet (8); the ragged [13,
#: 17]; [49152, 17] of the structure-of-arrays step; [49152, 128] of the
#: packed multislot step; [135040, 128] of the multi-array step
K3_SIZES = [1, 3, 4, 5, 7, 8, 9, 221, 835_584, 6_291_456, 17_285_120]
#: two keys whose low words are equal and whose high words differ
K3_SEEDS = [0x0000_0001_2345_6789, 0xFFFF_FFFE_2345_6789]


@pytest.mark.parametrize("seed", K3_SEEDS)
@pytest.mark.parametrize("n", K3_SIZES)
def test_stochastic_round_bit_for_bit_at_every_size(card, n, seed):
    g = torch.Generator(device=card).manual_seed(n)
    x = torch.randn(n, generator=g, device=card) * 100
    before = rounding.stochastic_round_bf16.launches
    out = rounding.stochastic_round_bf16(x, seed)
    ref = rounding.stochastic_round_bf16_plain(x, seed)
    torch.cuda.synchronize()
    assert rounding.stochastic_round_bf16.launches == before + 1
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))


def test_the_seeds_high_word_changes_every_group(card):
    """The key's high word reaches the kernel: two seeds that differ only
    there round 835,584 elements differently, each as the plain version."""
    x = torch.rand(835_584, device=card) + 1.0   # no exact bf16 values
    outs = []
    for seed in K3_SEEDS:
        out = rounding.stochastic_round_bf16(x, seed)
        ref = rounding.stochastic_round_bf16_plain(x, seed)
        assert torch.equal(out.view(torch.int16), ref.view(torch.int16))
        outs.append(out.view(torch.int16))
    differ = (outs[0] != outs[1]).float().mean().item()
    # a pair of independent draws rounds apart with chance 2p(1 - p), p
    # the dropped fraction: 1/3 on average over uniform fractions
    assert 0.32 < differ < 0.35, differ


def test_stochastic_round_refuses_what_the_kernel_cannot_read(card):
    """A non-contiguous or misaligned input is refused, as before: the
    caller copies it. The copy rounds as the plain version rounds the
    view."""
    base = torch.randn(64, 34, device=card)
    view = base[:, :17]
    with pytest.raises(ValueError, match="contiguous"):
        rounding.stochastic_round_bf16(view, 5)
    with pytest.raises(ValueError, match="16-byte aligned"):
        rounding.stochastic_round_bf16(base.view(-1)[1:], 5)
    out = rounding.stochastic_round_bf16(view.contiguous(), 5)
    ref = rounding.stochastic_round_bf16_plain(view, 5)
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))


@pytest.mark.parametrize("n", [1, 7, 8, 221, 8192, 8200, 835_584, 6_291_456,
                               17_285_120])
def test_rounding_geometry_mirrors_the_kernel(card, n):
    """ops/rounding.py's grid arithmetic (the CPU tests' subject) is what
    csrc/rounding.cu launches with; an empty kernel on that grid runs."""
    from monolith_tpu_torch import bench_rounding
    got = rounding.kernel_geometry(n)
    assert (got["threads"], got["octets"]) == (rounding.THREADS,
                                               rounding.OCTETS)
    assert got["sms"] == torch.cuda.get_device_properties(
        card).multi_processor_count
    assert got["blocks_per_sm"] >= 1
    assert got["grid"] == rounding.grid_size(n, got["blocks_per_sm"],
                                             got["sms"])
    bench_rounding.empty_launch(n)
    torch.cuda.synchronize()


@pytest.mark.parametrize("n", K3_SIZES)
def test_stochastic_round_equals_the_one_group_design(card, n):
    """The redesign changes no bit: it equals the earlier one-group kernel
    (csrc/baselines/rounding_one_group.cu) on the same input."""
    from monolith_tpu_torch import bench_rounding
    g = torch.Generator(device=card).manual_seed(n + 1)
    x = torch.randn(n, generator=g, device=card)
    old = torch.empty(n, dtype=torch.bfloat16, device=card)
    rounding.launch(bench_rounding.baseline_library(), x, K3_SEEDS[1], old)
    new = rounding.stochastic_round_bf16(x, K3_SEEDS[1])
    torch.cuda.synchronize()
    assert torch.equal(new.view(torch.int16), old.view(torch.int16))


@pytest.mark.parametrize("n", [65_536, 70_000, 135_168])
def test_row_kernels_above_the_16_bit_cap(card, n):
    """K1 and K2 on a bf16 pool [17 x 2^18, 128] at more than 65535 rows
    a call (multislot at batch 32768), ~1% of them -1."""
    g = torch.Generator(device=card).manual_seed(n)
    cap = 17 * (1 << 18)
    pool = torch.randn((cap, 128), generator=g, device=card).to(
        torch.bfloat16)
    rows = torch.randperm(cap, generator=g, device=card)[:n].int()
    rows[torch.rand(n, generator=g, device=card) < 0.01] = -1
    out = ops.gather_rows(pool, rows)
    assert torch.equal(out.view(torch.int16),
                       ops.gather_rows_plain(pool, rows).view(torch.int16))
    a, b = pool.clone(), pool.clone()
    ops.scatter_rows(a, rows, out + 1)
    ops.scatter_rows_plain(b, rows, out + 1)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


def _soa_deepfm(device, **engine):
    return Trainer(DeepFMTask(capacity_per_shard=4096, hidden=(32, 16),
                              init_scale=0.0),
                   TrainerConfig(engine=EngineConfig(**dict(
                       dict(unique_cap=512, new_cap=512), **engine)),
                       log_every=0),
                   device=device)


@pytest.mark.parametrize("engine", [dict(packed="off"),
                                    dict(compact_wire=False),
                                    dict(unique_cap=70000, new_cap=70000)],
                         ids=["soa", "int32", "cap70000"])
def test_multi_array_card_steps_match_cpu(card, engine):
    """The multi-array path on the card against the CPU from one carried
    state (at a cap of 70000 the fused wire, its table wide): losses rtol
    1e-5 under deterministic algorithms; a structure-of-arrays step
    launches no kernel (f32 table), a packed one K1 and K2 once."""
    from monolith_tpu_torch import ops as port_ops
    data = SyntheticCTR(num_users=400, num_items=300, batch_size=64, seed=11)
    batches = [data.batch() for _ in range(6)]
    cpu = _soa_deepfm("cpu", **engine)
    for i in range(3):
        cpu.train_step(*batches[i], ts=500 + i)
    gpu = _soa_deepfm(card, **engine)
    convert.load_state(gpu, convert.export_state(cpu))
    assert gpu.engine.fuse_wire == ("unique_cap" in engine)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for i in range(3, 6):
            port_ops.reset_launch_counts()
            lg = gpu.train_step(*batches[i], ts=500 + i)["loss"].item()
            counts = port_ops.launch_counts()
            lc = cpu.train_step(*batches[i], ts=500 + i)["loss"].item()
            np.testing.assert_allclose(lg, lc, rtol=1e-5)
            k = 0 if engine.get("packed") == "off" else 1
            assert counts == {"gather_rows": k, "scatter_rows": k,
                              "stochastic_round_bf16": 0}, counts
    finally:
        torch.use_deterministic_algorithms(False)


# ----------------------------------------------------------------------
# two ranks sharing the card through parallel.launch
# ----------------------------------------------------------------------

def _tiered_sharded_rank(rank, exchange, directory):
    """A small tiered ShardedTrainer of 2 shards on the rank's device: 4
    steps, a spill, 2 steps that revive, a delta restored into a fresh
    rank. Returns the losses, spilled and revived counts and the delta's
    rows."""
    from monolith_tpu_torch.parallel import ShardedTrainer, make_mesh
    from monolith_tpu_torch.parallel.launch import rank_device
    from monolith_tpu_torch.training import checkpoint
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    mesh = make_mesh(device=rank_device())

    def make():
        return ShardedTrainer(
            DeepFMTask(embedding_dim=8, capacity_per_shard=1024, hidden=(16,),
                       init_scale=0.0, ttl_seconds=10),
            TrainerConfig(engine=EngineConfig(
                num_shards=2, unique_cap=256, new_cap=256, tiered=True,
                exchange=exchange), log_every=0), mesh)
    tr = make()
    data = SyntheticCTR(num_users=60, num_items=40, batch_size=64, seed=3)
    losses = [float(tr.train_step(*data.batch(), ts=i)["loss"])
              for i in range(4)]
    spilled = tr.spill_expired(2)
    losses += [float(tr.train_step(*data.batch(), ts=4 + i)["loss"])
               for i in range(2)]
    path = checkpoint.save_delta(tr, directory, since_ts=4)
    applied = checkpoint.restore_delta(make(), path)
    return {"losses": losses, "spilled": spilled,
            "revived": tr.engine.archive_of("sparse").revived,
            "applied": applied}


@pytest.mark.parametrize("exchange", ["allgather", "a2a"])
def test_two_gloo_ranks_on_the_card_launch_tiered_like_the_cpu(
        card, exchange, tmp_path):
    """parallel.launch with backend='gloo', device='cuda:0': two ranks of a
    tiered ShardedTrainer on the card against the same two on the CPU
    (losses within 1e-5; spilled, revived and delta counts exactly)."""
    from monolith_tpu_torch.parallel.launch import launch
    got = launch(_tiered_sharded_rank, 2, backend="gloo", device="cuda:0",
                 args=(exchange, str(tmp_path / "card")))
    want = launch(_tiered_sharded_rank, 2, device="cpu",
                  args=(exchange, str(tmp_path / "cpu")))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["losses"], w["losses"], rtol=1e-5)
        assert (g["spilled"], g["revived"], g["applied"]) == (
            w["spilled"], w["revived"], w["applied"])
    assert sum(g["revived"] for g in got) > 0


def test_dryrun_on_two_gloo_ranks_sharing_the_card(card, capsys):
    from monolith_tpu_torch.parallel import dryrun
    out = dryrun.main(["--gloo-one-card", "2"])
    assert len(out) == 4
    assert capsys.readouterr().out.count(": OK") == 4
