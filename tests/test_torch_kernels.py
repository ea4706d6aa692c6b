"""K1/K2 (row gather / row scatter) of the PyTorch port against the JAX
package.

On the CPU the port's wrappers run their plain versions; the JAX reference
is table.gather_packed / table.scatter_packed, whose CPU path is the XLA
gather/scatter with the Pallas kernels' semantics (tests/test_table.py
holds the two equal on a TPU). Copies are exact, so every comparison is
bit for bit. The kernels themselves run on the card
(tests/test_torch_cuda.py, chip_smoke.py); what the CPU reaches of them is
their tile geometry (`tile_geometry`, `grid_size`, `tile_spans`, which
mirror csrc/rows.cu), held here by its invariants and by a tile-by-tile
walk that must reproduce the plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monolith_tpu.embedding import table as jtable
from monolith_tpu.models.deepfm import DeepFMTask as JaxDeepFMTask
from monolith_tpu_torch import build, ops
from monolith_tpu_torch.ops import scatter as pscatter

torch.set_num_threads(1)

CAP, P = 256, 128


def _spec():
    return JaxDeepFMTask(capacity_per_shard=CAP).tables()[0]


def _case(seed, n):
    """Pool [CAP, P], unique rows [n] with ~1/4 -1 entries, values [n, P]."""
    rng = np.random.default_rng(seed)
    pool = rng.normal(size=(CAP, P)).astype(np.float32)
    rows = rng.choice(CAP, size=n, replace=False).astype(np.int32)
    rows[rng.random(n) < 0.25] = -1
    values = rng.normal(size=(n, P)).astype(np.float32)
    return pool, rows, values


@pytest.mark.parametrize("n", [1, 7, 33, 100, 256])
@pytest.mark.parametrize("fn", ["plain", "wrapper"])
def test_gather_rows_matches_jax(n, fn):
    pool, rows, _ = _case(n, n)
    ref = np.asarray(jtable.gather_packed(_spec(), {"data": jnp.asarray(pool)},
                                          jnp.asarray(rows)))
    gather = (pscatter.gather_rows_plain if fn == "plain"
              else pscatter.gather_rows)
    out = gather(torch.from_numpy(pool), torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    assert (out[rows < 0] == 0).all()


@pytest.mark.parametrize("n", [1, 7, 33, 100, 256])
@pytest.mark.parametrize("fn", ["plain", "wrapper"])
def test_scatter_rows_matches_jax(n, fn):
    pool, rows, values = _case(100 + n, n)
    ref = np.asarray(jtable.scatter_packed(
        _spec(), {"data": jnp.asarray(pool)}, jnp.asarray(rows),
        jnp.asarray(values))["data"])
    scatter = (pscatter.scatter_rows_plain if fn == "plain"
               else pscatter.scatter_rows)
    pool_t = torch.from_numpy(pool.copy())
    out = scatter(pool_t, torch.from_numpy(rows), torch.from_numpy(values))
    assert out.data_ptr() == pool_t.data_ptr()  # written in place
    np.testing.assert_array_equal(pool_t.numpy().view(np.int32),
                                  ref.view(np.int32))


def test_out_of_range_rows_read_zeros_and_drop():
    pool, _, values = _case(5, 4)
    rows = np.array([CAP, -1, 3, CAP + 7], np.int32)
    out = pscatter.gather_rows(torch.from_numpy(pool), torch.from_numpy(rows))
    np.testing.assert_array_equal(out.numpy()[[0, 1, 3]], 0)
    np.testing.assert_array_equal(out.numpy()[2], pool[3])
    pool_t = torch.from_numpy(pool.copy())
    pscatter.scatter_rows(pool_t, torch.from_numpy(rows),
                          torch.from_numpy(values))
    expect = pool.copy()
    expect[3] = values[2]
    np.testing.assert_array_equal(pool_t.numpy(), expect)


def test_cpu_wrappers_count_no_launches():
    ops.reset_launch_counts()
    pool, rows, values = _case(9, 16)
    pscatter.gather_rows(torch.from_numpy(pool), torch.from_numpy(rows))
    pscatter.scatter_rows(torch.from_numpy(pool), torch.from_numpy(rows),
                          torch.from_numpy(values))
    assert pscatter.gather_rows.launches == 0
    assert pscatter.scatter_rows.launches == 0


def test_non_cpu_tensor_raises_instead_of_falling_back():
    """A tensor that is not on the CPU never takes the plain version: the
    wrapper launches the kernel or raises."""
    pool = torch.empty((CAP, P), device="meta")
    rows = torch.empty((8,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        pscatter.gather_rows(pool, rows)
    with pytest.raises(ValueError, match="CUDA"):
        pscatter.scatter_rows(pool, rows, torch.empty((8, P), device="meta"))


def test_kernel_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda _name: None)
    monkeypatch.setattr(build, "DEFAULT_NVCC", "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_kernel_library()


def test_scatter_rejects_mismatched_values():
    pool, rows, values = _case(11, 8)
    with pytest.raises(ValueError, match="dtype"):
        pscatter.scatter_rows(torch.from_numpy(pool), torch.from_numpy(rows),
                              torch.from_numpy(values).double())
    with pytest.raises(ValueError, match="match"):
        pscatter.scatter_rows(torch.from_numpy(pool), torch.from_numpy(rows),
                              torch.from_numpy(values[:, :64].copy()))


ROW_BYTES = [16, 32, 256, 512, 1024, 2048]


@pytest.mark.parametrize("row_bytes", ROW_BYTES)
def test_tile_geometry_fits_the_card(row_bytes):
    """Every width in use fits one block's 227 KB; a stage holds at least
    one row and at most one a lane, and starts on a 16-byte boundary (bulk
    copies need it), as does every row in it."""
    tile_rows, smem = pscatter.tile_geometry(row_bytes)
    stage = tile_rows * row_bytes
    assert 1 <= tile_rows <= 32
    assert stage <= pscatter.STAGE_BYTES and stage % 16 == 0
    assert smem == pscatter.WARPS * pscatter.STAGES * (stage + 8)
    assert smem <= 227 * 1024 == pscatter.MAX_SMEM
    # the barriers follow the stages: 8-byte aligned
    assert (pscatter.WARPS * pscatter.STAGES * stage) % 8 == 0
    # no wider stage would do: one more row overflows it or the warp
    assert tile_rows == 32 or (tile_rows + 1) * row_bytes > \
        pscatter.STAGE_BYTES


@pytest.mark.parametrize("row_bytes", [0, -16, 8, 24, 100, 16384])
def test_tile_geometry_rejects_what_the_kernels_do_not_take(row_bytes):
    with pytest.raises(ValueError, match="16-byte vectors|too wide"):
        pscatter.tile_geometry(row_bytes)


def _edge_counts(tile_rows):
    s = pscatter.STAGES
    return sorted({1, tile_rows - 1, tile_rows, tile_rows + 1,
                   s * tile_rows + 1,
                   2 * pscatter.WARPS * s * tile_rows + 3} - {0})


@pytest.mark.parametrize("grid_cap", [1, 3, 132])
@pytest.mark.parametrize("row_bytes", ROW_BYTES)
def test_tiles_cover_every_row_once(row_bytes, grid_cap):
    """The grid's warps walk tiles that cover [0, n) exactly once, each
    warp's k-th tile in stage k % STAGES, for n around the tile and ring
    sizes and for grids smaller than the tiles need (stages wrap)."""
    tile_rows, _ = pscatter.tile_geometry(row_bytes)
    for n in _edge_counts(tile_rows):
        grid = pscatter.grid_size(n, tile_rows, 1, grid_cap)
        tiles = -(-n // tile_rows)
        assert 1 <= grid <= grid_cap
        assert grid * pscatter.WARPS >= min(tiles, grid_cap * pscatter.WARPS)
        seen = np.zeros(n, np.int32)
        uses = {}
        for block, warp, stage, start, stop in pscatter.tile_spans(
                n, tile_rows, grid):
            assert 0 <= block < grid and 0 <= warp < pscatter.WARPS
            assert 0 < stop - start <= tile_rows and start % tile_rows == 0
            k = uses.get((block, warp), 0)
            assert stage == k % pscatter.STAGES
            uses[(block, warp)] = k + 1
            seen[start:stop] += 1
        assert (seen == 1).all(), (n, grid)
        # work is spread evenly: no warp walks more than one tile more
        # than another that has any
        assert max(uses.values()) - min(uses.values()) <= 1 or \
            len(uses) < grid * pscatter.WARPS


@pytest.mark.parametrize("n", [1, 15, 16, 17, 49, 256])
def test_tile_walk_reproduces_the_plain_versions(n):
    """K1 and K2 emulated tile by tile over the kernels' walk (a stage
    buffer filled row by row, zeros for rows outside [0, cap), then moved
    as one block) equal the plain versions bit for bit."""
    pool, rows, values = _case(200 + n, n)
    rows[::5] = CAP + 3   # beyond the pool as well as -1
    tile_rows, _ = pscatter.tile_geometry(P * 4)
    grid = pscatter.grid_size(n, tile_rows, 1, 2)
    out = np.full((n, P), np.nan, np.float32)
    scattered = pool.copy()
    for _b, _w, _s, start, stop in pscatter.tile_spans(n, tile_rows, grid):
        stage = np.zeros((stop - start, P), np.float32)
        for j, r in enumerate(rows[start:stop]):
            if 0 <= r < CAP:
                stage[j] = pool[r]
                scattered[r] = values[start + j]
        out[start:stop] = stage
    ref = pscatter.gather_rows_plain(torch.from_numpy(pool),
                                     torch.from_numpy(rows)).numpy()
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    ref_pool = pscatter.scatter_rows_plain(
        torch.from_numpy(pool.copy()), torch.from_numpy(rows),
        torch.from_numpy(values)).numpy()
    np.testing.assert_array_equal(scattered.view(np.int32),
                                  ref_pool.view(np.int32))

