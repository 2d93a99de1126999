"""The grouped sweep launches: tree functions, leaf table and host path.

* The grouped tree functions' plain path (``ops.fused_update_sweep_tree`` /
  ``fused_tracking_sweep_tree`` on CPU tensors) against the reference's
  tree functions, whose Pallas kernels run in interpret mode as
  ``tests/test_torch_kernels.py`` runs them, on a ragged tree made from a
  numpy seed: fp32 at atol = rtol = 1e-6 (the same fp32 operations), bf16
  at 1.5e-2 (the reference's own bf16 tolerance); frozen rows bit for bit.
* :func:`leaf_tables` and :func:`output_layout`, pure functions of shapes,
  dtypes and pointers: offsets, block prefixes, vec flags, chunking, empty
  leaves, dtype groups.
* The card's host path (``_launch_grouped``) on CPU memory, with the
  ``ctypes`` library replaced by a Python model of the CUDA kernel that
  walks the same blocks over the same table: outputs bit-equal to the
  plain version, views of one buffer per output, one launch per dtype group
  and per 48 leaves, ungated tracking handing back ``g_new`` itself.
The CUDA kernels themselves are held to the plain versions by
``tests/test_torch_kernels_gpu.py``, which skips without a card.
"""
import contextlib
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.prox import ops as jops
from repro.kernels.prox.kernel import sweep_params_table as j_table
from repro_torch.kernels.prox import kernel as tk
from repro_torch.kernels.prox import ops as tops

C = 3
DS = (1, 3, 10, 64, 7872)            # ragged leaf sizes a client
KINDS = ["l1", "mcp", "scad"]
TOL = {torch.float32: 1e-6, torch.bfloat16: 1.5e-2}
_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
TABLE = dict(lam=[1e-3, 1e-2], theta=4.0, alpha=[0.05, 0.2],
             gamma=[0.5, 0.9], beta=[1.0, 1.5])
MASK = np.array([[1, 0, 1], [0, 0, 0]], np.float32)   # config 1 all frozen
# the paper's Fig. 4 MLP (123 -> 64 -> 32 -> 10) leaves, elements a client
MLP_DS = (7872, 64, 2048, 32, 320, 10)
MLP_SHAPES = ((123, 64), (64,), (64, 32), (32,), (32, 10), (10,))


def _shape(S, d):
    """Leaf i of the ragged tree: 2-D, 1-D or 0-D after the (S, C) axes."""
    return (S, C) + ({64: (8, 8), 7872: (123, 64), 1: ()}.get(d, (d,)))


def _trees(seed, S, dtype, n=3):
    rng = np.random.default_rng(seed)
    trees = [{f"l{i}": (rng.standard_normal(_shape(S, d)) * 0.1
                        ).astype(np.float32) for i, d in enumerate(DS)}
             for _ in range(n)]
    tt = [{k: torch.from_numpy(v).to(dtype) for k, v in t.items()}
          for t in trees]
    jt = [{k: jnp.asarray(v, _JDT[dtype]) for k, v in t.items()}
          for t in trees]
    return tt, jt


def _tables(S):
    cols = {k: (v[:S] if isinstance(v, list) else v) for k, v in TABLE.items()}
    return (tk.sweep_params_table(**cols, device="cpu"),
            j_table(**{k: jnp.asarray(v) for k, v in cols.items()}))


def _one_config_trees(label, dtype, seed):
    """Three trees of the tree path's leaves, as numpy-seeded torch and
    jax dicts: the Fig. 4 MLP's six (10, ...) leaves, or a ragged tree of
    0-D to 3-D leaves."""
    shapes = ({f"l{i}": (10,) + s for i, s in enumerate(MLP_SHAPES)}
              if label == "mlp" else
              {"s": (), "a": (3,), "b": (1001,), "w": (8, 8),
               "v": (2, 5, 7), "big": (123, 64)})
    rng = np.random.default_rng(seed)
    trees = [{k: (rng.standard_normal(s) * 0.05).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    return ([{k: torch.from_numpy(np.asarray(v)).to(dtype)
              for k, v in t.items()} for t in trees],
            [{k: jnp.asarray(v, _JDT[dtype]) for k, v in t.items()}
             for t in trees])


def _masks(S, gated):
    if not gated:
        return None, None
    return torch.from_numpy(MASK[:S]), jnp.asarray(MASK[:S])


def _close(t, j, dtype):
    assert t.dtype == dtype and tuple(t.shape) == tuple(j.shape)
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


def _bits(t):
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                               else torch.int32)


def _assert_frozen(out, ref, mask):
    """Rows with mask <= 0 come back bit for bit as ``ref``."""
    if mask is None:
        return
    frozen = mask <= 0
    for k in ref:
        assert torch.equal(_bits(out[k][frozen]), _bits(ref[k][frozen]))


# ---------------------------------------------------------------------------
# Tree functions against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("S", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_update_tree_matches_reference(kind, S, gated, dtype):
    (x, y, nu), (jx, jy, jnu) = _trees(KINDS.index(kind) + 3 * S, S, dtype)
    tt, jt = _tables(S)
    tm, jm = _masks(S, gated)
    xo, nuo = tops.fused_update_sweep_tree(x, y, nu, tt, tm, kind=kind)
    jxo, jnuo = jops.fused_update_sweep_tree(jx, jy, jnu, jt, jm, kind=kind)
    assert list(xo) == list(x) and list(nuo) == list(nu)
    for k in x:
        _close(xo[k], jxo[k], dtype)
        _close(nuo[k], jnuo[k], dtype)
    _assert_frozen(xo, x, tm)
    _assert_frozen(nuo, nu, tm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("S", [1, 2])
def test_tracking_tree_matches_reference(S, gated, dtype):
    (y, gn, go), (jy, jgn, jgo) = _trees(20 + S, S, dtype)
    tt, jt = _tables(S)
    tm, jm = _masks(S, gated)
    yo, gk = tops.fused_tracking_sweep_tree(y, gn, go, tt, tm)
    jyo, jgk = jops.fused_tracking_sweep_tree(jy, jgn, jgo, jt, jm)
    for k in y:
        _close(yo[k], jyo[k], dtype)
        _close(gk[k], jgk[k], dtype)
        if not gated:
            assert gk[k] is gn[k]        # no copy
    _assert_frozen(yo, y, tm)
    _assert_frozen(gk, go, tm)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("tree", ["mlp", "ragged"])
@pytest.mark.parametrize("kind", KINDS)
def test_one_config_trees_match_reference(kind, tree, dtype):
    """``prox_tree`` / ``fused_update_tree`` (one grouped call each on the
    card, the plain versions here) against the reference's trees."""
    tt, jt = _one_config_trees(tree, dtype,
                               seed=len(tree) + KINDS.index(kind))
    hp = dict(kind=kind, lam=0.02, alpha=0.5, theta=4.0)
    got, want = tops.prox_tree(tt[0], **hp), jops.prox_tree(jt[0], **hp)
    assert list(got) == list(tt[0])
    for k in got:
        _close(got[k], want[k], dtype)
    gx, gn = tops.fused_update_tree(*tt, gamma=0.5, **hp)
    wx, wn = jops.fused_update_tree(*jt, gamma=0.5, **hp)
    for k in gx:
        _close(gx[k], wx[k], dtype)
        _close(gn[k], wn[k], dtype)


# ---------------------------------------------------------------------------
# The leaf table, a pure function of shapes, dtypes and pointers
# ---------------------------------------------------------------------------

def _ptrs(n, base=1 << 20, step=1 << 16):
    return [tuple(base + (5 * i + j) * step for j in range(5))
            for i in range(n)]


def _tables_of(*args):
    """leaf_tables' flat words as an (n, LEAF_WORDS) array, and launches."""
    words, launches = tk.leaf_tables(*args)
    return np.array(words, np.int64).reshape(-1, tk.LEAF_WORDS), launches


def test_output_offsets_are_16_byte_aligned():
    offsets, total = tk.output_layout([4, 40, 0, 6, 16])
    assert offsets == [0, 16, 64, 64, 80] and total == 96
    assert all(o % tk.ALIGN == 0 for o in offsets)
    assert tk.output_layout([]) == ([], 0)


def test_block_prefixes_of_the_mlp_step():
    """The Fig. 4 step: 8 + 1 + 2 + 1 + 1 + 1 tiles a row x 10 rows."""
    f32 = torch.float32
    table, launches = _tables_of(10, MLP_DS, [f32] * 6, _ptrs(6))
    assert table.shape == (6, tk.LEAF_WORDS) and table.dtype == np.int64
    assert table[:, 6].tolist() == [0, 80, 90, 110, 120, 130]
    assert table[:, 5].tolist() == list(MLP_DS)
    assert table[:, :5].tolist() == [list(p) for p in _ptrs(6)]
    assert launches == [tk.Launch(f32, 0, 6, 140)]


def test_vec_flags():
    f32, bf16 = torch.float32, torch.bfloat16
    p = _ptrs(4)
    p[2] = p[2][:3] + (p[2][3] + 4,) + p[2][4:]     # one misaligned output
    table, _ = _tables_of(2, (64, 10, 64, 64), [f32, f32, f32, bf16], p)
    # d = 10 and the misaligned pointer take scalar loads; bf16 d = 64
    # takes 16-byte vectors of 8
    assert table[:, 7].tolist() == [1, 0, 0, 1]
    ungated = [q[:4] + (0,) for q in _ptrs(1)]      # g_kept not written
    assert _tables_of(2, (8,), [f32], ungated)[0][0, 7] == 1


@pytest.mark.parametrize("shift", [0, 2])
def test_bf16_vec_flags(shift):
    """bf16 takes 16-byte vectors where d is a multiple of 8 and all five
    pointers are 16-byte aligned: d 8 and 2048, not 7, 9 or 2051, and
    none with one operand 2 bytes off (a view at an odd element)."""
    bf16, f32 = torch.bfloat16, torch.float32
    ds = (7, 8, 9, 2048, 2048 + 3)
    p = [(q[0] + shift,) + q[1:] for q in _ptrs(len(ds))]
    table, _ = _tables_of(2, ds, [bf16] * len(ds), p)
    want = [0, int(not shift), 0, int(not shift), 0]
    assert table[:, 7].tolist() == want
    # fp32 as before: d a multiple of 4 (8, 2048), pointers aligned
    table, _ = _tables_of(2, ds, [f32] * len(ds), p)
    assert table[:, 7].tolist() == want
    assert tk.VEC == {f32: 4, bf16: 8}


def test_chunks_above_the_table_limit():
    n = 2 * tk.MAX_LEAVES + 4
    tile = tk.TILES[torch.float32]
    ds = [1 + (i % 3) * tile for i in range(n)]     # 1, 2 or 3 tiles
    table, launches = _tables_of(5, ds, [torch.float32] * n, _ptrs(n))
    assert [(ln.start, ln.stop) for ln in launches] == [
        (0, 48), (48, 96), (96, n)]
    assert table[:, 0].tolist() == [p[0] for p in _ptrs(n)]   # in order
    for ln in launches:
        tiles = [-(-d // tile) for d in ds[ln.start:ln.stop]]
        firsts = np.cumsum([0] + [5 * t for t in tiles])
        assert table[ln.start:ln.stop, 6].tolist() == firsts[:-1].tolist()
        assert ln.blocks == firsts[-1]


def test_block_prefixes_per_dtype():
    """Each dtype's rows take ceil(d / tile) blocks of its own tile: fp32
    1,024 elements, bf16 4,096 (256 threads x 8 x 2); a launch past 2^31 -
    1 blocks raises, counted in its dtype's tile."""
    f32, bf16 = torch.float32, torch.bfloat16
    assert tk.TILES == {f32: 1024, bf16: 4096}
    ds = (1, 4096, 4097, 3 * 4096, 311_427_072)   # the last: the LM head
    table, launches = _tables_of(2, ds, [bf16] * 5, _ptrs(5))
    tiles = [1, 1, 2, 3, 76032]
    assert table[:, 6].tolist() == np.cumsum([0] + [2 * t for t in tiles
                                                    ])[:-1].tolist()
    assert launches == [tk.Launch(bf16, 0, 5, 2 * sum(tiles))]
    table, launches = _tables_of(2, ds, [f32] * 5, _ptrs(5))
    assert launches[0].blocks == 2 * sum(-(-d // 1024) for d in ds)
    # 2^31 fp32 tiles of one row raise; the same d in bf16 is 2^29 blocks
    big = 1024 * 2**31
    with pytest.raises(ValueError, match="exceeds"):
        tk.leaf_tables(1, (big,), [f32], _ptrs(1))
    assert tk.leaf_tables(1, (big,), [bf16], _ptrs(1))[1] == [
        tk.Launch(bf16, 0, 1, 2**29)]
    with pytest.raises(ValueError, match="exceeds"):
        tk.leaf_tables(1, (4 * big,), [bf16], _ptrs(1))


def test_the_training_step_in_blocks_and_bytes():
    """The full-width training step: Qwen3-1.7B's 311 bf16 leaves
    (2,032,264,192 parameters, the model built on ``meta``) for 2 clients
    are 7 launches, every leaf on the vector route, 992,482 blocks of 4,096
    elements (3,969,364 at the 1,024-element tile); the byte bounds of
    ``sweep_trees`` 12.13 ms (update, 5 trees), 9.71 (tracking, 4) and
    10.92 for both under the gate [1, 0] (4.5)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import HW
    from repro_torch.models import build_model
    module, _ = build_model(get_config("qwen3-1.7b"), device="meta").init(0)
    ds = [p.numel() for _, p in module.named_parameters()]
    assert len(ds) == 311 and sum(ds) == 2_032_264_192
    table, launches = _tables_of(2, ds, [torch.bfloat16] * 311, _ptrs(311))
    assert len(launches) == 7 and table[:, 7].tolist() == [1] * 311
    assert sum(ln.blocks for ln in launches) == 992_482
    assert sum(2 * -(-d // 1024) for d in ds) == 3_969_364
    tree = 2 * 2 * sum(ds)
    bounds = [tk.sweep_trees(update, live) * tree / HW["hbm_bandwidth"] * 1e3
              for update, live in ((True, None), (False, None), (True, 0.5),
                                   (False, 0.5))]
    assert [round(b, 2) for b in bounds] == [12.13, 9.71, 10.92, 10.92]


def test_the_route_leaves_take_both_routes_in_both_dtypes():
    """``ROUTE_LEAVES``, the card's check of both routes, at the storage
    offsets it gives: bf16 vectors at d 8, 2048 and 2^20 only, fp32 at
    the aligned d 1024 only; every dtype on both routes, bf16 first."""
    base = 1 << 24
    ptrs = [tuple(base + (5 * i + j) * (1 << 24) + k * dt.itemsize
                  for j in range(5))
            for i, (_, dt, k) in enumerate(tk.ROUTE_LEAVES)]
    table, launches = _tables_of(2, [d for d, _, _ in tk.ROUTE_LEAVES],
                                 [dt for _, dt, _ in tk.ROUTE_LEAVES], ptrs)
    assert [ln.dtype for ln in launches] == [torch.bfloat16, torch.float32]
    assert table[:, 5].tolist() == [d for d, _, _ in tk.ROUTE_LEAVES]
    assert table[:, 7].tolist() == [0, 0, 1, 0, 0, 1, 0, 1, 0, 0,
                                    0, 1, 0]
    assert list(tk.ROUTE_GATES.values())[0] is None
    assert all(len(m) == 2 for m in list(tk.ROUTE_GATES.values())[1:])


def test_empty_leaves_are_skipped():
    f32 = torch.float32
    table, launches = _tables_of(3, (0, 5, 0), [f32] * 3, _ptrs(3))
    assert launches == [tk.Launch(f32, 0, 1, 3)]
    assert table[:, 5].tolist() == [5]
    assert table[:, :5].tolist() == [list(_ptrs(3)[1])]
    assert _tables_of(0, (5, 6), [f32] * 2, _ptrs(2))[1] == []


def test_mixed_dtypes_split_into_two_groups():
    f32, bf16 = torch.float32, torch.bfloat16
    dts = [bf16, f32, bf16, f32]
    table, launches = _tables_of(2, (4, 2048, 8, 4), dts, _ptrs(4))
    assert launches == [tk.Launch(bf16, 0, 2, 4), tk.Launch(f32, 2, 4, 6)]
    p = _ptrs(4)                                    # leaves 0, 2 then 1, 3
    assert table[:, 0].tolist() == [p[0][0], p[2][0], p[1][0], p[3][0]]
    assert table[:, 6].tolist() == [0, 2, 0, 4]     # each launch from 0


def test_table_is_packed_into_a_reused_buffer():
    f32 = torch.float32
    words, _ = tk.leaf_tables(4, (3, 9), [f32] * 2, _ptrs(2))
    assert len(words) == 2 * tk.LEAF_WORDS
    addr = tk._packed(words)
    assert tk._packed(words) == addr

    def at(a, n):
        return np.frombuffer((ctypes.c_int64 * n).from_address(a),
                             np.int64).tolist()

    assert at(addr, len(words)) == words
    n = tk.MAX_LEAVES + 2                     # more than the buffer holds
    many, _ = tk.leaf_tables(4, (5,) * n, [f32] * n, _ptrs(n))
    grown = tk._packed(many)
    assert at(grown, len(many)) == many
    assert tk._packed(words) == grown         # the grown buffer is kept


# ---------------------------------------------------------------------------
# The host path on CPU memory, against a Python model of the kernel
# ---------------------------------------------------------------------------

_CT = {0: (ctypes.c_float, torch.float32), 1: (ctypes.c_uint16,
                                               torch.bfloat16)}


def _at(addr, n, dtype_code):
    """``n`` elements at ``addr`` as a tensor sharing that memory."""
    ct, dt = _CT[dtype_code]
    if n == 0:
        return torch.empty(0, dtype=dt)
    return torch.frombuffer((ct * n).from_address(addr), dtype=dt)


class _ModelLib:
    """The grouped entry points of ``prox_sweep.cu``, block by block: each
    block finds its leaf by the table's prefixes, then its row and its
    tile (of the dtype's ``TILES``), and runs the plain version on that
    tile (frozen rows copied).  A leaf's vec flag must follow the kernel's
    rule (d a multiple of the dtype's ``VEC``, the five pointers 16-byte
    aligned); ``routes`` records each leaf's (dtype, d, vec)."""

    def __init__(self):
        self.calls = []
        self.routes = []

    def _run(self, addr, n, params, mask, C, blocks, dtype, tile_fn):
        table = np.frombuffer((ctypes.c_int64 * (n * tk.LEAF_WORDS))
                              .from_address(addr), np.int64)
        table = table.reshape(n, tk.LEAF_WORDS).copy()
        assert 1 <= n <= tk.MAX_LEAVES and table[0, 6] == 0
        self.calls.append((n, blocks, dtype))
        dt = _CT[dtype][1]
        isz, tile = dt.itemsize, tk.TILES[dt]
        for *p, d, first, vec in table.tolist():
            aligned = all(q % 16 == 0 for q in p if q)
            assert vec == int(d % tk.VEC[dt] == 0 and aligned)
            self.routes.append((dt, d, vec))
        for b in range(blocks):
            leaf = 0
            while leaf + 1 < n and b >= table[leaf + 1, 6]:
                leaf += 1
            *p, d, first, vec = (int(v) for v in table[leaf])
            tiles = -(-d // tile)
            row, t = divmod(b - first, tiles)
            start = t * tile
            cnt = min(tile, d - start)
            off = (row * d + start) * isz
            io = [_at(q + off, cnt, dtype) if q else None for q in p]
            prow = _at(params + 20 * (row // C), 5, 0).reshape(1, 5)
            live = mask is None or float(_at(mask + 4 * row, 1, 0)) > 0
            tile_fn(io, prow, live, cnt)

    def prox_sweep_update_grouped(self, addr, n, params, mask, C, blocks,
                                  kind, dtype, stream):
        name = {v: k for k, v in tk.KINDS.items()}[kind]

        def tile(io, prow, live, cnt):
            x, y, nu, xo, nuo = io
            if live:
                rx, rn = tk.fused_update_sweep_plain(
                    *(t.reshape(1, 1, cnt) for t in (x, y, nu)), prow,
                    kind=name)
                xo.copy_(rx.reshape(-1))
                nuo.copy_(rn.reshape(-1))
            else:
                xo.copy_(x)
                nuo.copy_(nu)

        self._run(addr, n, params, mask, C, blocks, dtype, tile)
        return 0

    def prox_apply_grouped(self, addr, n, params, kind, dtype, stream):
        """The grid the C entry takes from the table: the last leaf's first
        block plus its tiles (one row a leaf)."""
        name = {v: k for k, v in tk.KINDS.items()}[kind]
        last = np.frombuffer((ctypes.c_int64 * (n * tk.LEAF_WORDS))
                             .from_address(addr), np.int64)[-tk.LEAF_WORDS:]
        blocks = int(last[6]) + -(-int(last[5]) // tk.TILES[_CT[dtype][1]])

        def tile(io, prow, live, cnt):
            x, y, nu, out, unused = io
            assert y is nu is unused is None and live
            out.copy_(tk.prox_plain(x, kind=name, lam=prow[0, 0],
                                    theta=prow[0, 1], alpha=prow[0, 2]))

        self._run(addr, n, params, None, 1, blocks, dtype, tile)
        return 0

    def prox_sweep_tracking_grouped(self, addr, n, params, mask, C, blocks,
                                    dtype, stream):
        def tile(io, prow, live, cnt):
            y, gn, go, yo, gk = io
            assert (gk is None) == (mask is None)
            if live:
                ry, _ = tk.fused_tracking_sweep_plain(
                    *(t.reshape(1, 1, cnt) for t in (y, gn, go)), prow)
                yo.copy_(ry.reshape(-1))
                if gk is not None:
                    gk.copy_(gn)
            else:
                yo.copy_(y)
                gk.copy_(go)

        self._run(addr, n, params, mask, C, blocks, dtype, tile)
        return 0


@pytest.fixture
def model_lib(monkeypatch):
    """Route ``_launch_grouped`` to the model on CPU memory."""
    lib = _ModelLib()
    monkeypatch.setattr(tk, "_lib", lambda: lib)
    monkeypatch.setattr(tk, "_stream_ptr", lambda device: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    tk.reset_launch_counts()
    yield lib
    tk.reset_launch_counts()


def _tree_leaves(seed, shapes, dtypes, n=3):
    rng = np.random.default_rng(seed)
    return [[torch.from_numpy(np.asarray(rng.standard_normal(s) * 0.1,
                                         np.float32)).to(dt)
             for s, dt in zip(shapes, dtypes)] for _ in range(n)]


def _assert_views_of_one_buffer(outs, ins):
    storages = {o.untyped_storage().data_ptr() for o in outs}
    assert len(storages) == 1
    for o, a in zip(outs, ins):
        assert o.shape == a.shape and o.dtype == a.dtype
        assert o.is_contiguous() and o.data_ptr() % tk.ALIGN == 0


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("lead", [1, 2])
def test_host_path_matches_plain_on_the_mlp_tree(model_lib, gated, lead):
    head = (10,) if lead == 1 else (1, 10)
    shapes = [head + s for s in ((123, 64), (64,), (64, 32), (32,),
                                 (32, 10), (10,))]
    x, y, nu = _tree_leaves(7, shapes, [torch.float32] * 6)
    params, _ = _tables(1)
    mask = (torch.tensor([[1, 0, 1, 1, 0, 1, 1, 1, 0, 1]], dtype=torch.float32)
            if gated else None)
    got = tk._launch_grouped("fused_update_sweep", "fused_sweep",
                             list(zip(x, y, nu)), params, mask, lead, "mcp")
    want = tk.fused_update_sweep_grouped_plain(x, y, nu, params, mask,
                                               kind="mcp", lead=lead)
    trk = tk._launch_grouped("fused_tracking_sweep", "tracking_sweep",
                             list(zip(y, nu, x)), params, mask, lead)
    trk_want = tk.fused_tracking_sweep_grouped_plain(y, nu, x, params, mask,
                                                     lead=lead)
    for outs, refs in ((got, want), (trk, trk_want)):
        for o, r in zip(outs, refs):
            for a, b in zip(o, r):
                assert torch.equal(_bits(a), _bits(b))
    assert model_lib.calls == [(6, 140, 0), (6, 140, 0)]
    assert tk.LAUNCH_COUNTS == {"fused_sweep": 1, "tracking_sweep": 1}
    for outs in got:
        _assert_views_of_one_buffer(outs, x)
    _assert_views_of_one_buffer(trk[0], y)
    if gated:
        _assert_views_of_one_buffer(trk[1], y)
    else:
        assert all(g is n_ for g, n_ in zip(trk[1], nu))


@pytest.mark.parametrize("kind", KINDS)
def test_host_path_mixed_dtypes_and_chunks(model_lib, kind):
    """A ragged tree of 100 leaves, fp32 and bf16 mixed, S = 2 with one
    all-frozen config: one launch per dtype and per 48 leaves."""
    S, n = 2, 100
    f32, bf16 = torch.float32, torch.bfloat16
    dts = [bf16 if i % 3 == 0 else f32 for i in range(n)]
    shapes = [_shape(S, DS[i % len(DS)]) if i % 7 else (S, C, 0)
              for i in range(n)]
    x, y, nu = _tree_leaves(11, shapes, dts)
    params, _ = _tables(S)
    mask = torch.from_numpy(MASK)
    got = tk._launch_grouped("fused_update_sweep", "fused_sweep",
                             list(zip(x, y, nu)), params, mask, 2, kind)
    want = tk.fused_update_sweep_grouped_plain(x, y, nu, params, mask,
                                               kind=kind)
    for o, r in zip(got, want):
        for a, b in zip(o, r):
            assert torch.equal(_bits(a), _bits(b))
    for out, ref in zip(got, (x, nu)):
        _assert_frozen(dict(enumerate(out)), dict(enumerate(ref)), mask)
    # leaves with elements: 85 (every 7th is empty), fp32 56 (the first
    # group: leaf 0 is empty, leaf 1 fp32), bf16 29
    assert [c[0] for c in model_lib.calls] == [48, 8, 29]
    assert [c[2] for c in model_lib.calls] == [0, 0, 1]
    assert tk.LAUNCH_COUNTS["fused_sweep"] == 3


def _at_offset(t, k):
    """``t``'s values in a contiguous view ``k`` elements past the start of
    its own allocation (a pointer 16-byte aligned only where k elements
    are a multiple of 16 bytes)."""
    flat = torch.empty(t.numel() + k, dtype=t.dtype)
    view = flat[k:].view(t.shape)
    view.copy_(t)
    return view


# (elements a row, dtype, storage offset) of a ragged mixed tree: bf16
# rows on the vector route (8, 2048, and 8200: three tiles, the last
# ragged; a view 8 elements in) and on the scalar one (7, 9, 2051, views 1
# and 4 elements in); fp32 likewise at its own rule (4 elements, 16 bytes)
ROUTE_LEAVES = ((7, torch.bfloat16, 0), (8, torch.bfloat16, 0),
                (9, torch.bfloat16, 0), (2048, torch.bfloat16, 0),
                (2051, torch.bfloat16, 0), (8200, torch.bfloat16, 0),
                (64, torch.bfloat16, 1), (64, torch.bfloat16, 4),
                (64, torch.bfloat16, 8), (7, torch.float32, 0),
                (1030, torch.float32, 0), (1032, torch.float32, 0),
                (64, torch.float32, 1), (64, torch.float32, 4))


@pytest.mark.parametrize("gated", [False, True])
def test_host_path_vector_and_scalar_routes_on_a_ragged_mixed_tree(
        model_lib, gated):
    """Both sweep entry points over ``ROUTE_LEAVES`` (S = 2, C = 3; gated:
    ``MASK``, config 1 all frozen) on CPU memory: every leaf's vec flag as
    the kernel's rule, both routes taken in both dtypes, outputs bit-equal
    to the plain version, frozen rows bit for bit."""
    S = 2
    shapes = [(S, C, d) for d, _, _ in ROUTE_LEAVES]
    dts = [dt for _, dt, _ in ROUTE_LEAVES]
    x, y, nu = ([_at_offset(t, k) for t, (_, _, k) in zip(ts, ROUTE_LEAVES)]
                for ts in _tree_leaves(29, shapes, dts))
    params, _ = _tables(S)
    mask = torch.from_numpy(MASK) if gated else None
    for kind in KINDS:
        got = tk._launch_grouped("fused_update_sweep", "fused_sweep",
                                 list(zip(x, y, nu)), params, mask, 2, kind)
        want = tk.fused_update_sweep_grouped_plain(x, y, nu, params, mask,
                                                   kind=kind)
        for o, r in zip(got, want):
            for a, b in zip(o, r):
                assert torch.equal(_bits(a), _bits(b))
        for out, ref in zip(got, (x, nu)):
            _assert_frozen(dict(enumerate(out)), dict(enumerate(ref)), mask)
    got = tk._launch_grouped("fused_tracking_sweep", "tracking_sweep",
                             list(zip(y, nu, x)), params, mask, 2)
    want = tk.fused_tracking_sweep_grouped_plain(y, nu, x, params, mask)
    for o, r in zip(got, want):
        for a, b in zip(o, r):
            assert torch.equal(_bits(a), _bits(b))
    _assert_frozen(dict(enumerate(got[0])), dict(enumerate(y)), mask)
    _assert_frozen(dict(enumerate(got[1])), dict(enumerate(x)), mask)
    if not gated:
        assert all(g is n_ for g, n_ in zip(got[1], nu))
    # one launch a dtype a call, bf16 first (the order of appearance); the
    # routes as listed (CPU allocations are 64-byte aligned)
    assert [c[2] for c in model_lib.calls] == [1, 0] * 4
    want = [(dt, d, int(d % tk.VEC[dt] == 0 and k * dt.itemsize % 16 == 0))
            for d, dt, k in sorted(ROUTE_LEAVES,
                                   key=lambda r: r[1] == torch.float32)]
    assert [vec for *_, vec in want] == [0, 1, 0, 1, 0, 1, 0, 0, 1,
                                         0, 0, 1, 0, 1]
    assert model_lib.routes == want * 4


def test_host_path_skips_an_empty_tree(model_lib):
    x = [torch.zeros((2, 3, 0))] * 2
    params, _ = _tables(2)
    xs, nus = tk._launch_grouped("fused_update_sweep", "fused_sweep",
                                 [(a, a, a) for a in x], params, None, 2,
                                 "l1")
    assert [t.shape for t in xs + nus] == [(2, 3, 0)] * 4
    assert model_lib.calls == [] and tk.LAUNCH_COUNTS["fused_sweep"] == 0


@pytest.mark.parametrize("route", ["plain", "card"])
def test_grouped_wrappers_check_their_inputs(model_lib, route):
    """The inputs ``test_wrappers_check_their_inputs`` lists, as one-leaf
    trees beside a good leaf, through the grouped plain path and through
    the card's host path."""
    x, y, nu = (a[0] for a in _tree_leaves(3, [(2, C, 10)],
                                           [torch.float32]))
    tt, _ = _tables(2)
    good = (x, y, nu)

    def upd(bad, params, mask=None, kind="l1"):
        leaves = [good, bad]
        if route == "plain":
            return tk.fused_update_sweep_grouped(*zip(*leaves), params, mask,
                                                 kind=kind)
        return tk._launch_grouped("fused_update_sweep", "fused_sweep",
                                  leaves, params, mask, 2, kind)

    def trk(bad, params):
        if route == "plain":
            return tk.fused_tracking_sweep_grouped(*zip(good, bad), params)
        return tk._launch_grouped("fused_tracking_sweep", "tracking_sweep",
                                  [good, bad], params, None, 2)

    with pytest.raises(ValueError, match="no kernel for device"):
        meta = tuple(t.to("meta") for t in good)
        if route == "plain":
            tk.fused_update_sweep_grouped(*zip(meta), tt.to("meta"))
        else:
            tk._launch_grouped("fused_update_sweep", "fused_sweep", [meta],
                               tt.to("meta"), None, 2, "l1")
    with pytest.raises(ValueError, match="contiguous"):
        upd(tuple(t.transpose(0, 1).contiguous().transpose(0, 1)
                  for t in good), tt)
    with pytest.raises(TypeError):
        trk(tuple(t.double() for t in good), tt)
    with pytest.raises(ValueError, match="params"):
        trk(good, tt[:1])
    with pytest.raises(ValueError, match="mask"):
        upd(good, tt, torch.ones(2, C + 1))
    with pytest.raises(ValueError, match="kind"):
        upd(good, tt, kind="box")
    with pytest.raises(ValueError, match="leading axes"):
        upd(tuple(t[:1] for t in good), tt)
    with pytest.raises(ValueError, match="differ"):
        upd((x, y[..., :5].contiguous(), nu), tt)
    assert model_lib.calls == [] and not tk.LAUNCH_COUNTS


def test_block_prefixes_of_the_tree_path():
    """``prox_tree`` over the Fig. 4 model (six (10, ...) leaves) is one
    row a leaf: 77 + 1 + 20 + 1 + 4 + 1 = 104 tiles in one launch."""
    f32 = torch.float32
    ptrs = [(p[0], 0, 0, p[3], 0) for p in _ptrs(6)]
    table, launches = _tables_of(1, [10 * d for d in MLP_DS], [f32] * 6,
                                 ptrs)
    assert table[:, 6].tolist() == [0, 77, 78, 98, 99, 103]
    assert table[:, 7].tolist() == [1, 1, 1, 1, 1, 1]
    assert launches == [tk.Launch(f32, 0, 6, 104)]


@pytest.mark.parametrize("kind", KINDS)
def test_prox_host_path_matches_plain(model_lib, kind):
    """The prox's grouped call on CPU memory: one row a leaf, the grid from
    the table, one (1, 5) row; a mixed fp32 / bf16 tree of 0-D to 3-D and
    empty leaves takes one launch per dtype, bit-equal to plain."""
    f32, bf16 = torch.float32, torch.bfloat16
    shapes = [(), (10, 123, 64), (0,), (1001,), (10, 64), (2, 3, 5), (4,)]
    dts = [f32, f32, f32, bf16, f32, bf16, f32]
    (xs,) = _tree_leaves(13, shapes, dts, n=1)
    row = tk.hyper_row(xs[0], 0.02, 4.0, 0.5)
    (got,) = tk._launch_grouped("prox", "prox", [(x,) for x in xs], row,
                                None, 0, kind)
    want = tk.prox_grouped_plain(xs, kind=kind, lam=0.02, theta=4.0,
                                 alpha=0.5)
    for a, b, x in zip(got, want, xs):
        assert a.shape == x.shape and a.dtype == x.dtype
        assert torch.equal(_bits(a), _bits(b))
    # fp32: 1 + 77 + 1 (d 640) + 1 (d 4) blocks; bf16: 1 + 1
    assert model_lib.calls == [(4, 80, 0), (2, 2, 1)]
    assert tk.LAUNCH_COUNTS == {"prox": 2}
    _assert_views_of_one_buffer([a for a in got if a.numel()],
                                [x for x in xs if x.numel()])


def test_one_config_update_host_path_matches_plain(model_lib):
    """``fused_update_tree``'s grouped call (lead 0: one row a leaf, one
    (1, 5) row) over the MLP tree and 100 ragged leaves: bit-equal to the
    plain version, one launch per 48 leaves."""
    leaves = [(10,) + s for s in MLP_SHAPES]
    x, y, nu = _tree_leaves(17, leaves, [torch.float32] * 6)
    row = tk.hyper_row(x[0], 1e-4, 4.0, 0.05, 0.8)
    got = tk._launch_grouped("fused_update", "fused_update",
                             list(zip(x, y, nu)), row, None, 0, "mcp")
    want = tk.fused_update_grouped_plain(x, y, nu, kind="mcp", lam=1e-4,
                                         theta=4.0, alpha=0.05, gamma=0.8)
    for o, r in zip(got, want):
        for a, b in zip(o, r):
            assert torch.equal(_bits(a), _bits(b))
    assert model_lib.calls == [(6, 104, 0)]
    many = [(7,), (3, 3), ()] * 33 + [(1025,)]
    x, y, nu = _tree_leaves(19, many, [torch.float32] * 100)
    got = tk._launch_grouped("fused_update", "fused_update",
                             list(zip(x, y, nu)), row, None, 0, "scad")
    want = tk.fused_update_grouped_plain(x, y, nu, kind="scad", lam=1e-4,
                                         theta=4.0, alpha=0.05, gamma=0.8)
    for o, r in zip(got, want):
        for a, b in zip(o, r):
            assert torch.equal(_bits(a), _bits(b))
    assert [c[0] for c in model_lib.calls[1:]] == [48, 48, 4]
    assert tk.LAUNCH_COUNTS == {"fused_update": 4}


def test_one_config_grouped_wrappers_check_their_inputs():
    ((x, y),) = _tree_leaves(23, [(4, 5), (6,)], [torch.float32] * 2, n=1)
    with pytest.raises(ValueError, match="differ"):
        tk.fused_update_grouped([x], [y], [x])
    with pytest.raises(TypeError):
        tk.prox_grouped([x, y.double()])
    with pytest.raises(ValueError, match="kind"):
        tk.prox_grouped([x], kind="box")
    with pytest.raises(ValueError, match="no kernel for device"):
        tk.prox_grouped([x.to("meta")])
    assert tk.prox_grouped([]) == []
    assert tk.fused_update_grouped([], [], []) == ([], [])
    # any layout: leaves are made contiguous first
    xt = x.t()
    assert torch.equal(tk.prox_grouped([xt], kind="mcp")[0],
                       tk.prox_plain(xt.contiguous(), kind="mcp"))
