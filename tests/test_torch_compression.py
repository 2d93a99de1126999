"""Port parity: compression specs, compressors, CHOCO, wire payloads, bytes.

The port's compressors against ``repro.core.compression`` on the same
numpy rows, with the reference's threefry uniforms injected through the
spec's ``uniforms`` hook (recomputed outside ``jit`` by the same
``fold_in`` chain): ``none``, ``topk``, ``randk``, ``qsgd`` and ``mixed``
are bit-equal, alone and stacked over a sweep axis, because both sides do
the same fp32 operations in the same order (a descending sort's values, a
gather, compares, ``floor``, one division each).  One CHOCO exchange mixes
the increment with a matrix product that sums in another order: rtol 1e-6
/ atol 1e-7.  Wire payloads round-trip exactly; ``repro_torch.analysis.
comm`` equals ``repro.analysis.comm`` exactly (numpy on the same values).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import comm as jac
from repro.core import CohortSampler as JSampler
from repro.core import MixPlan as JPlan
from repro.core import compression as jc
from repro.core import schedule as jsch
from repro.core.mixing import apply_mix as j_apply_mix
from repro.core.topology import mixing_matrix
from repro_torch.analysis import comm as tac
from repro_torch.core import (CohortSampler, CommMemory, CompressionSpec,
                              MixPlan, MixSchedule, active_compression,
                              apply_mix, as_mixed, as_schedule, choco_mix,
                              comm_memory, comm_round_keys, compress,
                              compression_of, pack_payload, stack_schedules,
                              stack_specs, unpack_payload, validate_schedule,
                              wire_mode)
from repro_torch.core.compression import DrawKey, hashed_uniforms
from repro_torch.core.schedule import shard_compressed_qmix, wire_supported

MIX_TOL = dict(rtol=1e-6, atol=1e-7)
CPU = dict(device="cpu")


def _rows(seed, n=6, d=32):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def _tree(seed, lead=(6,)):
    """Two leaves (a 2-D and a 1-D per client), keys in sorted order so
    leaf i is the reference's i-th pytree leaf."""
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal(lead + (4, 8)).astype(np.float32),
            "b": rng.standard_normal(lead + (5,)).astype(np.float32)}


def ref_draws(jkey):
    """A port ``uniforms`` hook that returns the reference's draws: fold the
    port key's path (round, variable, leaf) into ``jkey`` and draw
    ``uniform(key, (rows, d))``; a stacked ``jkey`` (S, 2) draws per point,
    a single one is shared over a sweep's leading dim."""
    def draw(key: DrawKey, shape):
        def one(k, shp):
            for p in key.path:
                k = jax.random.fold_in(k, p)
            return jax.random.uniform(k, shp)
        if jkey.ndim == 2:
            u = jax.vmap(lambda k: one(k, tuple(shape[1:])))(jkey)
        else:
            u = jnp.broadcast_to(one(jkey, tuple(shape[-2:])), shape)
        return torch.from_numpy(np.array(u)).to(key.seed.device)
    return draw


def _specs(kind):
    """The same spec in both packages (port with the reference's draws)."""
    if kind == "none":
        return jc.CompressionSpec.none(), CompressionSpec.none(**CPU)
    if kind.startswith("topk"):
        rate = float(kind.split("_")[1])
        return (jc.CompressionSpec.topk(rate),
                CompressionSpec.topk(rate, **CPU))
    if kind.startswith("randk"):
        rate = float(kind.split("_")[1])
        j = jc.CompressionSpec.randk(rate, seed=3)
        return j, dataclasses.replace(
            CompressionSpec.randk(rate, seed=3, **CPU),
            uniforms=ref_draws(j.key))
    bits = int(kind.split("_")[1])
    j = jc.CompressionSpec.qsgd(bits, seed=5)
    return j, dataclasses.replace(CompressionSpec.qsgd(bits, seed=5, **CPU),
                                  uniforms=ref_draws(j.key))


KINDS = ["none", "topk_0.05", "topk_0.2", "topk_0.5", "topk_1.0",
         "randk_0.3", "randk_0.9", "qsgd_1", "qsgd_2", "qsgd_4", "qsgd_8"]


def _assert_bits(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("kind,mixed", [(k, False) for k in KINDS] + [
    (k, True) for k in ("none", "topk_0.2", "randk_0.3", "qsgd_4")])
def test_compressors_match_reference_bit_for_bit(kind, mixed):
    js, ts = _specs(kind)
    if mixed:
        js, ts = jc.as_mixed(js), as_mixed(ts)
        if kind.startswith(("none", "topk")):     # as_mixed's key: seed 0
            ts = dataclasses.replace(ts, uniforms=ref_draws(js.key))
    tree = _tree(1)
    # rows with ties at the k-th magnitude keep every tied entry
    tree["a"][0, 0, :4] = 2.0
    tree["a"][0, 1, :4] = -2.0
    want = jc.compress(js, {k: jnp.asarray(v) for k, v in tree.items()})
    got = compress(ts, {k: torch.from_numpy(v) for k, v in tree.items()})
    for k in tree:
        _assert_bits(got[k], want[k])
    # and a round's key: fold_in(fold_in(key, r), var) in both
    if js.key is not None:
        jk = jc.comm_round_keys(js, 3)[1]
        tk = comm_round_keys(ts, 3)[1]
        want = jc.compress(js, {k: jnp.asarray(v) for k, v in tree.items()},
                           jk)
        got = compress(ts, {k: torch.from_numpy(v) for k, v in tree.items()},
                       tk)
        for k in tree:
            _assert_bits(got[k], want[k])


def test_stacked_mixed_grid_matches_reference_and_native_points():
    """A mixed grid on (S, C, ...) leaves (``lead=2``): each point equals
    the reference's vmapped compress and the point's native spec alone,
    bit for bit."""
    kinds = ["none", "topk_0.25", "randk_0.5", "qsgd_4", "topk_0.1"]
    pairs = [_specs(k) for k in kinds]
    jgrid = jc.stack_specs([j for j, _ in pairs])
    tgrid = dataclasses.replace(stack_specs([
        dataclasses.replace(t, uniforms=None) for _, t in pairs]),
        uniforms=ref_draws(jgrid.key))
    assert tgrid.kind == jgrid.kind == "mixed"
    S = len(kinds)
    tree = _tree(2, lead=(S, 6))
    key_j = jax.vmap(lambda sp: jc.comm_round_keys(sp, 2)[0])(jgrid)
    want = jax.vmap(lambda sp, k, t: jc.compress(sp, t, k))(
        jgrid, key_j, {k: jnp.asarray(v) for k, v in tree.items()})
    got = compress(tgrid, {k: torch.from_numpy(v) for k, v in tree.items()},
                   comm_round_keys(tgrid, 2)[0], lead=2)
    for s, (_, ts) in enumerate(pairs):
        alone = compress(ts, {k: torch.from_numpy(v[s])
                              for k, v in tree.items()},
                         comm_round_keys(ts, 2)[0])
        for k in tree:
            _assert_bits(got[k][s], want[k][s])
            _assert_bits(got[k][s], alone[k])


def test_hashed_draws_are_per_point_and_per_path():
    """The port's own draws: in [0, 1), a sweep point's block equals the
    same seed alone, and round / variable / leaf each change the draws."""
    seeds = torch.tensor([0, 7, 0], dtype=torch.int64)
    key = DrawKey(seeds, (4, 1, 0))
    u = hashed_uniforms(key, (3, 10, 50))
    assert u.dtype == torch.float32 and 0.0 <= float(u.min()) \
        and float(u.max()) < 1.0
    alone = hashed_uniforms(DrawKey(seeds[1], (4, 1, 0)), (10, 50))
    assert torch.equal(u[1], alone) and torch.equal(u[0], u[2])
    assert not torch.equal(u[0], u[1])
    for path in ((5, 1, 0), (4, 0, 0), (4, 1, 1)):
        assert not torch.equal(hashed_uniforms(DrawKey(seeds[1], path),
                                               (10, 50)), alone)
    shared = hashed_uniforms(DrawKey(seeds[1], (4, 1, 0)), (3, 10, 50))
    assert all(torch.equal(shared[s], alone) for s in range(3))
    assert abs(float(u.mean()) - 0.5) < 0.02
    # randk keeps ~rate of the coordinates, scaled by 1 / rate
    spec = CompressionSpec.randk(0.25, seed=11, **CPU)
    x = {"w": torch.ones(64, 256)}
    q = compress(spec, x)["w"]
    kept = q != 0
    assert abs(float(kept.float().mean()) - 0.25) < 0.02
    assert torch.equal(q[kept], torch.full_like(q[kept], 4.0))


def test_stack_specs_and_as_mixed_structure():
    pairs = [_specs(k) for k in ("none", "topk_0.1", "qsgd_4")]
    js = jc.stack_specs([j for j, _ in pairs])
    ts = stack_specs([dataclasses.replace(t, uniforms=None)
                      for _, t in pairs])
    assert ts.kind == js.kind == "mixed"
    assert ts.is_stacked and ts.n_sweep == js.n_sweep == 3
    for f in ("rate", "bits", "ef_step", "kind_id"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    np.testing.assert_array_equal(ts.kind_id.numpy(), [0, 1, 3])
    # same-kind specs stay native; points select back
    rates = stack_specs([CompressionSpec.topk(r, **CPU) for r in (0.1, 0.5)])
    jrates = jc.stack_specs([jc.CompressionSpec.topk(r) for r in (0.1, 0.5)])
    assert rates.kind == jrates.kind == "topk" and rates.n_sweep == 2
    assert float(rates.point(1).rate) == float(jrates.point(1).rate) == 0.5
    assert rates.point(1).rate.ndim == 0
    assert as_mixed(ts) is ts
    for bad in ([], [ts]):
        with pytest.raises(ValueError):
            stack_specs(bad)
    hooked = dataclasses.replace(CompressionSpec.topk(0.1, **CPU),
                                 uniforms=lambda k, s: None)
    with pytest.raises(ValueError, match="uniforms hook"):
        stack_specs([hooked, CompressionSpec.topk(0.2, **CPU)])
    # a schedule grid normalises its specs the same way (none for None)
    base = as_schedule(MixPlan.from_topology("ring", 6, **CPU))
    jbase = jsch.as_schedule(JPlan.from_topology("ring", 6))
    grid = stack_schedules([base, base.with_compression(
        CompressionSpec.qsgd(4, **CPU))])
    jgrid = jsch.stack_schedules([jbase, jbase.with_compression(
        jc.CompressionSpec.qsgd(4))])
    assert grid.compress.kind == jgrid.compress.kind == "mixed"
    np.testing.assert_array_equal(grid.compress.kind_id.numpy(),
                                  np.asarray(jgrid.compress.kind_id))
    assert grid.point(1).compress.kind_id.ndim == 0
    assert grid.to("cpu").compress.seed.device.type == "cpu"
    assert compression_of(grid) is grid.compress
    assert active_compression(base.with_compression(
        CompressionSpec.none(**CPU))) is None


@pytest.mark.parametrize("case", ["topk_zero", "randk_above_one",
                                  "qsgd_zero_bits", "not_a_spec",
                                  "stacked_on_one_schedule",
                                  "stacked_bad_rate"])
def test_spec_validation(case):
    base = as_schedule(MixPlan.from_topology("ring", 6, **CPU))
    jbase = jsch.as_schedule(JPlan.from_topology("ring", 6))
    if case == "topk_zero":
        for make in (jc.CompressionSpec.topk,
                     lambda r: CompressionSpec.topk(r, **CPU)):
            with pytest.raises(ValueError, match="rate"):
                make(0.0)
    elif case == "randk_above_one":
        for make in (jc.CompressionSpec.randk,
                     lambda r: CompressionSpec.randk(r, **CPU)):
            with pytest.raises(ValueError, match="rate"):
                make(1.5)
    elif case == "qsgd_zero_bits":
        for make in (jc.CompressionSpec.qsgd,
                     lambda b: CompressionSpec.qsgd(b, **CPU)):
            with pytest.raises(ValueError, match="bits"):
                make(0)
    elif case == "not_a_spec":
        for sched in (base, jbase):
            with pytest.raises(TypeError, match="CompressionSpec"):
                sched.with_compression(object())
    elif case == "stacked_on_one_schedule":
        grid = stack_specs([CompressionSpec.topk(r, **CPU)
                            for r in (0.1, 0.2)])
        with pytest.raises(ValueError, match="stack whole schedules"):
            base.with_compression(grid)
    else:
        spec = CompressionSpec.topk(0.5, **CPU)
        grid = stack_schedules([base.with_compression(spec)] * 2)
        bad = dataclasses.replace(grid, compress=dataclasses.replace(
            grid.compress, rate=torch.tensor([0.5, 1.5])))
        validate_schedule(grid, 6)
        with pytest.raises(ValueError, match="rate"):
            validate_schedule(bad, 6)


def test_wire_paths_wait_for_the_backends_slice():
    """The wire paths have landed: ``wire_supported`` decides as the
    reference's does, and on one process (a size-1 axis holding all six
    clients) the packed exchange equals the dense mix of ``q``, exactly
    where the payload fits (the per-rank gloo runs are in
    ``test_torch_distributed.py``)."""
    from repro_torch.launch.mesh import ShardAxis

    ring = ([(+1, 1 / 3), (-1, 1 / 3)], 1 / 3)
    jplans = {"dense": JPlan.from_topology("ring", 6),
              "circulant": JPlan.circulant(*ring),
              "complete": JPlan.complete()}
    tplans = {"dense": MixPlan.from_topology("ring", 6, **CPU),
              "circulant": MixPlan.circulant(*ring, **CPU),
              "complete": MixPlan.complete()}
    jspecs = {"qsgd": jc.CompressionSpec.qsgd(4),
              "topk": jc.CompressionSpec.topk(0.25),
              "topk_wire": jc.CompressionSpec.topk(0.25, wire_k=16)}
    tspecs = {"qsgd": CompressionSpec.qsgd(4, **CPU),
              "topk": CompressionSpec.topk(0.25, **CPU),
              "topk_wire": CompressionSpec.topk(0.25, wire_k=16, **CPU)}
    for p in jplans:
        for k in jspecs:
            assert wire_supported(as_schedule(tplans[p]).with_compression(
                tspecs[k])) == jsch.wire_supported(jsch.as_schedule(
                    jplans[p]).with_compression(jspecs[k])), (p, k)
    ax = ShardAxis("c", 1, 0)
    rng = np.random.default_rng(0)
    for k in ("qsgd", "topk_wire"):
        sched = as_schedule(tplans["dense"]).with_compression(tspecs[k])
        x = torch.from_numpy(rng.standard_normal((6, 8, 4)).astype(
            np.float32))
        q = compress(tspecs[k], {"w": x})["w"]
        got = shard_compressed_qmix(sched, 0, q, ax, 1)
        want = apply_mix(tplans["dense"], {"w": q})["w"]
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# Wire payloads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["sparse_topk", "sparse_randk", "quant"])
def test_pack_unpack_round_trips_exact(mode):
    """Compressed rows survive pack / unpack exactly: ``wire_k`` slots hold
    every nonzero of a top-k row (k = 8) and of a rand-k row at rate 0.2
    (<= 16 nonzeros here); the int8 words of QSGD at 5 bits are the row's
    levels exactly.  One op is not bit-equal: the quant payload's scale is
    ``max|q| = (norm * s) / s``, one rounding from the row's norm, so an
    unpacked QSGD value may differ from q by up to 3 ulps (200 seeds x
    bits 1-7 reach 3; the reference shares this, ``test_compression.py``
    holds it at rtol 1e-6).  The port's payload unpacks to the reference's
    bit for bit."""
    x = {"w": torch.from_numpy(_rows(1))}
    if mode == "sparse_topk":
        js = jc.CompressionSpec.topk(0.25, wire_k=8)
        ts = CompressionSpec.topk(0.25, wire_k=8, **CPU)
    elif mode == "sparse_randk":
        js = jc.CompressionSpec.randk(0.2, wire_k=16)
        ts = CompressionSpec.randk(0.2, wire_k=16, **CPU)
    else:
        js = jc.CompressionSpec.qsgd(5, wire_bits=8)
        ts = CompressionSpec.qsgd(5, wire_bits=8, **CPU)
    assert wire_mode(ts) == jc.wire_mode(js) == mode.split("_")[0]
    q = compress(ts, x)["w"]
    assert int((q != 0).sum(-1).max()) <= max(ts.wire_k, 1) or \
        mode == "quant"
    payload = pack_payload(ts, q)
    if mode == "quant":
        assert payload[0].dtype == torch.int8 and \
            int(payload[0].abs().max()) == 31
    else:
        assert payload[1].dtype == torch.int32
    back = unpack_payload(ts, payload, q.shape[-1], q.dtype)
    if mode == "quant":
        levels = q / torch.amax(q.abs(), -1, keepdim=True) * 31.0
        assert torch.equal(payload[0].to(torch.float32), torch.round(levels))
        np.testing.assert_array_max_ulp(back.numpy(), q.numpy(), maxulp=3)
    else:
        assert torch.equal(back, q)
    jq = jnp.asarray(q.numpy())
    jback = jc.unpack_payload(js, jc.pack_payload(js, jq), q.shape[-1],
                              jq.dtype)
    _assert_bits(back, jback)


def test_unpackable_specs_raise():
    for spec in (CompressionSpec.topk(0.25, **CPU), as_mixed(
            CompressionSpec.qsgd(4, **CPU))):
        assert wire_mode(spec) is None
        with pytest.raises(ValueError, match="wire payload"):
            pack_payload(spec, torch.zeros(6, 8))
        with pytest.raises(ValueError, match="wire payload"):
            unpack_payload(spec, (), 8)


# ---------------------------------------------------------------------------
# CHOCO exchange
# ---------------------------------------------------------------------------

def test_choco_mix_none_equals_the_plain_mix():
    plan = MixPlan.dense(mixing_matrix("ring", 6), **CPU)
    x = {k: torch.from_numpy(v) for k, v in _tree(4).items()}
    mem = comm_memory(x)
    plain = apply_mix(plan, x)
    for spec in (None, CompressionSpec.none(**CPU)):
        out, mem2 = choco_mix(spec, lambda t: apply_mix(plan, t), x, mem)
        assert mem2 is mem
        for k in x:
            assert torch.equal(out[k], plain[k])


def test_comm_memory_mass_conservation():
    """xhat' - xhat = q exactly, and what top-k leaves out is retried: on a
    fixed x, four top-k(0.25) increments drain 32 coordinates."""
    x = {"w": torch.from_numpy(_rows(0, n=4, d=32))}
    spec = CompressionSpec.topk(0.25, **CPU)
    mem = comm_memory(x)
    for _ in range(4):
        q = compress(spec, {"w": x["w"] - mem.xhat["w"]})["w"]
        _, new = choco_mix(spec, lambda t: t, x, mem)
        assert torch.equal(new.xhat["w"] - mem.xhat["w"], q)
        assert torch.equal(new.s["w"], mem.s["w"] + q)
        mem = new
    torch.testing.assert_close(mem.xhat["w"], x["w"], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("kind", ["topk_0.25", "randk_0.5", "qsgd_4"])
def test_choco_mix_matches_reference(kind):
    """One exchange from nonzero memory over a ring (round 2, variable y):
    out, xhat and s at the mix's tolerance (MIX_TOL)."""
    js, ts = _specs(kind)
    W = mixing_matrix("ring", 6)
    jplan, tplan = JPlan.dense(W), MixPlan.dense(W, **CPU)
    x, xhat, s = _tree(5), _tree(6), _tree(7)
    jmem = jc.CommMemory({k: jnp.asarray(v) for k, v in xhat.items()},
                         {k: jnp.asarray(v) for k, v in s.items()})
    tmem = CommMemory({k: torch.from_numpy(v) for k, v in xhat.items()},
                      {k: torch.from_numpy(v) for k, v in s.items()})
    jout, jnew = jc.choco_mix(js, lambda t: j_apply_mix(jplan, t),
                              {k: jnp.asarray(v) for k, v in x.items()},
                              jmem, jc.comm_round_keys(js, 2)[1])
    tout, tnew = choco_mix(ts, lambda t: apply_mix(tplan, t),
                           {k: torch.from_numpy(v) for k, v in x.items()},
                           tmem, comm_round_keys(ts, 2)[1])
    for k in x:
        _assert_bits(tnew.xhat[k], jnew.xhat[k])    # no product: exact
        np.testing.assert_allclose(tnew.s[k].numpy(), np.asarray(jnew.s[k]),
                                   **MIX_TOL)
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   **MIX_TOL)


# ---------------------------------------------------------------------------
# Bytes accounting: exactly the reference's numbers
# ---------------------------------------------------------------------------

def _spec_pairs():
    out = {
        "none": (None, None),
        "none_spec": (jc.CompressionSpec.none(), CompressionSpec.none(**CPU)),
        "topk": (jc.CompressionSpec.topk(0.25),
                 CompressionSpec.topk(0.25, **CPU)),
        "topk_wire": (jc.CompressionSpec.topk(0.25, wire_k=20),
                      CompressionSpec.topk(0.25, wire_k=20, **CPU)),
        "randk_odd": (jc.CompressionSpec.randk(0.37),
                      CompressionSpec.randk(0.37, **CPU)),
        "qsgd": (jc.CompressionSpec.qsgd(4), CompressionSpec.qsgd(4, **CPU)),
    }
    names = ("none_spec", "topk", "randk_odd", "qsgd", "topk_wire")
    out["mixed_grid"] = (jc.stack_specs([out[n][0] for n in names]),
                         stack_specs([out[n][1] for n in names]))
    out["rate_grid"] = (
        jc.stack_specs([jc.CompressionSpec.topk(r) for r in (0.1, 0.5)]),
        stack_specs([CompressionSpec.topk(r, **CPU) for r in (0.1, 0.5)]))
    return out


@pytest.mark.parametrize("d", [1, 10, 64, 1001])
def test_payload_bytes_and_bits_per_coord_equal_reference(d):
    for name, (js, ts) in _spec_pairs().items():
        for fn in ("payload_row_bytes", "spec_bits_per_coord"):
            want = getattr(jac, fn)(js, d)
            got = getattr(tac, fn)(ts, d)
            assert np.shape(got) == np.shape(want), (name, fn)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} {fn}")


def _sched_pairs():
    n = 8
    W, Wt = mixing_matrix("ring", n), mixing_matrix("torus", n)
    ring = [(+1, 1 / 3), (-1, 1 / 3)]
    pairs = {
        "dense": (jsch.as_schedule(JPlan.dense(W)),
                  as_schedule(MixPlan.dense(W, **CPU))),
        "circulant": (jsch.as_schedule(JPlan.circulant(ring, 1 / 3)),
                      as_schedule(MixPlan.circulant(ring, 1 / 3, **CPU))),
        "complete": (jsch.as_schedule(JPlan.complete()),
                     as_schedule(MixPlan.complete())),
        "identity": (jsch.as_schedule(JPlan.identity()),
                     as_schedule(MixPlan.identity())),
        "chebyshev": (jsch.MixSchedule.chebyshev(JPlan.dense(W), 3),
                      MixSchedule.chebyshev(MixPlan.dense(W, **CPU), 3)),
        "chebyshev_circulant": (
            jsch.MixSchedule.chebyshev(JPlan.circulant(ring, 1 / 3), 2, n=n),
            MixSchedule.chebyshev(MixPlan.circulant(ring, 1 / 3, **CPU), 2,
                                  n=n)),
        "stacked": (jsch.MixSchedule.stacked([JPlan.dense(W),
                                              JPlan.dense(Wt)]),
                    MixSchedule.stacked([MixPlan.dense(W, **CPU),
                                         MixPlan.dense(Wt, **CPU)])),
        "alternating": (
            jsch.MixSchedule.alternating([JPlan.dense(Wt), JPlan.dense(W)]),
            MixSchedule.alternating([MixPlan.dense(Wt, **CPU),
                                     MixPlan.dense(W, **CPU)])),
        "lazy_drawn": (jsch.MixSchedule.lazy(JPlan.dense(W), 0.6, rounds=5,
                                             seed=3),
                       MixSchedule.lazy(MixPlan.dense(W, **CPU), 0.6,
                                        rounds=5, seed=3)),
        "lazy_circulant": (
            jsch.MixSchedule.lazy(JPlan.circulant(ring, 1 / 3), 0.5,
                                  rounds=4, n=n, seed=1),
            MixSchedule.lazy(MixPlan.circulant(ring, 1 / 3, **CPU), 0.5,
                             rounds=4, n=n, seed=1)),
        "lazy_sampler": (jsch.MixSchedule.lazy(JPlan.dense(W), 0.7),
                         MixSchedule.lazy(MixPlan.dense(W, **CPU), 0.7)),
    }
    for name, (jsamp, tsamp) in {
            "cohort_bernoulli": (JSampler.bernoulli(0.5, n, seed=0),
                                 CohortSampler.bernoulli(0.5, n, seed=0,
                                                         **CPU)),
            "cohort_fixed": (JSampler.fixed_size(3, n, seed=2),
                             CohortSampler.fixed_size(3, n, seed=2, **CPU)),
            "cohort_full": (JSampler.full(6, n), CohortSampler.full(6, n,
                                                                    **CPU)),
    }.items():
        pairs[name] = (jsch.MixSchedule.cohort(JPlan.dense(W), jsamp),
                       MixSchedule.cohort(MixPlan.dense(W, **CPU), tsamp))
    return n, pairs


@pytest.mark.parametrize("spec", ["none", "topk", "qsgd", "mixed_grid"])
def test_round_bytes_equal_reference(spec):
    """round_edges, collectives_per_round, round_wire_bytes (one and two
    variables), device_wire_bytes and sweep_round_bytes, per schedule
    kind, at the expectation (``r=None``) and at rounds whose draws both
    packages share (pre-drawn numpy masks, round-stacked plans).  A cohort
    round's exact count reads the port's own hashed mask (the reference
    draws with threefry): it is held against a direct count."""
    n, pairs = _sched_pairs()
    js, ts = _spec_pairs()[spec]
    for name, (jsched, tsched) in pairs.items():
        if js is not None and not ts.is_stacked:
            jsched, tsched = (jsched.with_compression(js),
                              tsched.with_compression(ts))
        rounds = [None] + ([0, 1, 4, 9] if name in (
            "stacked", "alternating", "lazy_drawn", "lazy_circulant") else [])
        for r in rounds:
            assert tac.round_edges(tsched, n, r) == jac.round_edges(
                jsched, n, r), (name, r)
            for nv in (1, 2):
                np.testing.assert_array_equal(
                    tac.round_wire_bytes(tsched, 17, n, r, nv),
                    jac.round_wire_bytes(jsched, 17, n, r, nv),
                    err_msg=f"{name} r={r}")
        assert tac.collectives_per_round(tsched) == \
            jac.collectives_per_round(jsched)
        assert tac.device_wire_bytes(tsched, 300, n, 4) == \
            jac.device_wire_bytes(jsched, 300, n, 4), name
        if name.startswith("cohort"):
            mask = tsched.sampler.mask_at(2).numpy() > 0.5
            off = (np.abs(mixing_matrix("ring", n)) > 1e-12) & ~np.eye(
                n, dtype=bool)
            assert tac.round_edges(tsched, n, 2) == float(np.count_nonzero(
                off & np.outer(mask, mask)))
    # a stacked grid: per point, equal to the reference and to each point
    jbase, tbase = pairs["dense"]
    if ts is not None and ts.is_stacked:
        jgrid = jsch.stack_schedules([jbase.with_compression(js.point(s))
                                      for s in range(js.n_sweep)])
        tgrid = stack_schedules([tbase.with_compression(ts.point(s))
                                 for s in range(ts.n_sweep)])
    else:
        jgrid = jsch.stack_schedules([jbase, jbase.with_compression(js)]
                                     if js is not None else [jbase] * 2)
        tgrid = stack_schedules([tbase, tbase.with_compression(ts)]
                                if ts is not None else [tbase] * 2)
    np.testing.assert_array_equal(tac.sweep_round_bytes(tgrid, 64, n),
                                  jac.sweep_round_bytes(jgrid, 64, n))
    np.testing.assert_array_equal(
        tac.sweep_round_bytes(tbase, 64, n),
        jac.sweep_round_bytes(jbase, 64, n))
    for fn in (tac.round_edges, lambda s, n: tac.device_wire_bytes(
            s, 8, n, 2)):
        with pytest.raises(ValueError, match="sweep point"):
            fn(tgrid, n)
