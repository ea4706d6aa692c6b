"""The reference against a CPU run of the port at a small size: the cell
comes out correct, each number far under its limit."""

import numpy as np
import pytest

from portbench import run
from portbench.reference import train
from portbench.tests import small


def test_port_on_the_cpu_matches_the_reference():
    result = small.execute()
    assert result["correct"], result["checks"]
    for name, c in result["checks"].items():
        assert c["value"] <= c["limit"] / 10, (name, c)


def test_first_block_is_one_block_of_the_window():
    """The comparison reads one block of steps_per_dispatch steps, the
    window's own call, and every number of it."""
    from portbench.drivers import train_replay
    files = small.files()
    ctx = run.context(small.CELL, files, 5, 1.0, False, device="cpu",
                      log=lambda s: None)
    trainer, _ = train_replay.build(ctx)
    calls = []
    block = trainer.train_step_block
    trainer.train_step_block = lambda *a, **k: calls.append(1) or block(
        *a, **k)
    world = ctx.stream.World(ctx.cfg, ctx.seed)
    K = ctx.cfg["steps_per_dispatch"]
    batches = train_replay.make_batches(world, K, ctx.cfg["batch_size"], 1)
    obs = train_replay.first_block(ctx, trainer, batches)
    assert calls == [1] and len(obs["losses"]) == K == len(obs["preds"])
    assert set(files["limits"]) == {"loss_gap", "pred_gap", "accum_gap",
                                    "change_gap", "rows_gap"}


def test_steps_that_do_not_run_as_a_block_are_refused():
    """Caps past the port's 16-bit wire make it step one by one: the run
    stops rather than compare a path the window would not time."""
    files = small.files()
    files["cfg"].update(unique_cap=65536, new_cap=65536)
    with pytest.raises(RuntimeError, match="one block"):
        run.execute(small.CELL, 5, 1.0, False, device="cpu", files=files,
                    log=lambda s: None)


def test_dedup_is_first_occurrence_order():
    uniq, pos = train.dedup(np.array([5, -1, 3, 5, 7, 3], np.int64))
    assert uniq.tolist() == [5, 3, 7]
    assert pos.tolist() == [0, -1, 1, 0, 2, 1]


def test_init_seed_keys_step_and_table():
    seeds = {train.init_seed(7, s, t) for s in range(4) for t in range(3)}
    assert len(seeds) == 12
    assert all(0 <= s < 1 << 63 for s in seeds)


def test_cell_files_are_found_by_name():
    f = run.cell_files(small.CELL)
    assert f["cfg"]["name"] == f["workload"]["config"]
    assert set(f["limits"])
