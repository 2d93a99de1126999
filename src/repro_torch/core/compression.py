"""Compression as an operand: the :class:`CompressionSpec`.

Port of ``repro/core/compression.py``.  DEPOSITUM cuts communication by
communicating every T0 steps; compressing what *is* sent is the other
lever (CHOCO-gossip, Koloskova et al. 2019; the accuracy-vs-bytes frontier
of arXiv 2107.12048).  A spec says what a comm step transmits:

* ``none``        — identity.  A schedule carrying it runs the plain dense
  path bit for bit (:func:`active_compression` returns None for it).
* ``topk(rate)``  — keep the ``round(rate * d)`` largest-magnitude
  coordinates of each client row (threshold semantics: ties at the k-th
  magnitude all survive).
* ``randk(rate)`` — Bernoulli(rate) coordinate sampling scaled by
  ``1 / rate`` (unbiased).
* ``qsgd(bits)``  — stochastic rounding to ``2^bits - 1`` levels of each
  row's max magnitude (unbiased).
* ``mixed``       — ``kind_id`` selects the kind per sweep point, so a grid
  that mixes kinds (top-k rates, QSGD bits and a ``none`` baseline) runs
  as one sweep; :func:`stack_specs` converts heterogeneous specs to it.

``kind``, ``wire_k`` and ``wire_bits`` are structure; ``rate``, ``bits``,
``ef_step``, ``seed`` and ``kind_id`` are tensors on one device, ``()`` or
``(S,)`` after :func:`stack_specs`, as :class:`~repro_torch.core.hyper.
Hyper` and :class:`~repro_torch.core.mixing.MixPlan` are.  The compressors
divide by these device tensors, so on the card each division is a true
division (PyTorch's CUDA division by a CPU scalar multiplies by its
reciprocal instead).

Execution is CHOCO-style error feedback around any mixing operand: each
mixed variable keeps a public copy ``xhat`` and the running mix ``s = W
xhat``, updated from the compressed increment, so only ``q`` is mixed:

    q     = C(x - xhat)
    xhat' = xhat + q
    s'    = s + mix(q)
    x'    = x + ef_step * (s' - xhat')

**Random draws.**  The reference draws rand-k and QSGD uniforms with JAX's
threefry: ``fold_in(fold_in(key, r), var)`` per round and variable,
``fold_in(., leaf)`` per leaf, then ``uniform(key, (rows, d))``.  PyTorch
cannot reproduce threefry, so the port keeps the chain and replaces the
generator: a :class:`DrawKey` is the spec's int64 ``seed`` tensor with the
host integers folded into it, and :func:`hashed_uniforms` hashes ``(seed,
r, var, leaf, index in the row block)`` with the counter hash of
:mod:`repro_torch.core.cohort`.  The draws stay on the device, come out
the same on the CPU and the card, and need no host sync; each sweep point
draws from its own seed.  A spec's ``uniforms`` hook replaces the hash
(parity tests inject the reference's draws through it).

The packed wire payloads (:func:`pack_payload` / :func:`unpack_payload`)
round-trip exactly; :func:`repro_torch.core.schedule.shard_compressed_qmix`
puts them on the collectives of a sharded client axis.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.cohort import _M32, _mix32
from repro_torch.obs.trace import annotate

Tree = dict  # name -> (rows..., ...) tensor

_KINDS = ("none", "topk", "randk", "qsgd", "mixed")

#: Branch order of the ``mixed`` kind (the values ``kind_id`` takes), as in
#: the reference.
KIND_IDS = {"none": 0, "topk": 1, "randk": 2, "qsgd": 3}

_LEAVES = ("rate", "bits", "ef_step", "seed", "kind_id")


class DrawKey(NamedTuple):
    """Where a compressor's uniforms come from: the spec's int64 ``seed``
    tensor (``()`` or ``(S,)``) and the host integers folded into it so far
    (round, variable, leaf), the reference's ``fold_in`` chain.  ``row0``
    is the global index of the first client row drawn for: a process
    holding a block of a sharded client axis draws its rows' uniforms,
    those of the same rows in the whole stacked state."""

    seed: torch.Tensor
    path: tuple = ()
    row0: int = 0


def fold_in(key: DrawKey, data: int) -> DrawKey:
    """``key`` with one more integer folded in (no device work)."""
    return key._replace(path=key.path + (int(data),))


def hashed_uniforms(key: DrawKey, shape) -> torch.Tensor:
    """float32 uniforms in [0, 1) for a block of rows ``shape = (..., rows,
    d)``: element ``(i, j)`` of a point is a function of ``(seed, path,
    (row0 + i) * d + j)`` alone, so the draws of a sweep point equal those
    of the same spec run alone, and a shard's rows those of the same rows
    stacked.  A ``(S,)`` seed gives each point its own block; a ``()``
    seed shares one over the leading dims."""
    h = _mix32(key.seed & _M32)
    for p in key.path:
        h = _mix32(h ^ (p & _M32))
    rows, d = shape[-2:]
    idx = torch.arange(key.row0 * d, (key.row0 + rows) * d,
                       device=h.device, dtype=torch.int64)
    idx = (idx & _M32).reshape(rows, d)
    u = (_mix32(h.reshape(h.shape + (1, 1)) ^ idx) >> 8).to(torch.float32)
    return (u * 2.0 ** -24).expand(tuple(shape))


def _dev_f32(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """What the gossip step transmits.

    Build with the classmethod constructors.  ``kind``, ``wire_k`` and
    ``wire_bits`` are structure: two specs stack only when they agree on
    them.  ``wire_k`` (sparse kinds) / ``wire_bits`` (qsgd) size the packed
    payload; ``wire_k=0`` means no packed form (compression still happens
    and is accounted).  ``uniforms``, when set, is called as
    ``uniforms(key, shape)`` in place of :func:`hashed_uniforms`.
    """

    kind: str
    wire_k: int = 0
    wire_bits: int = 8
    rate: Optional[torch.Tensor] = None      # topk/randk: () or (S,) f32
    bits: Optional[torch.Tensor] = None      # qsgd: () or (S,) f32
    ef_step: Optional[torch.Tensor] = None   # CHOCO gamma: () or (S,) f32
    seed: Optional[torch.Tensor] = None      # randk/qsgd: () or (S,) int64
    kind_id: Optional[torch.Tensor] = None   # mixed: () or (S,) int64
    uniforms: Optional[Callable[[DrawKey, tuple], torch.Tensor]] = None

    # -- constructors -------------------------------------------------------
    @classmethod
    def none(cls, *, device="cuda") -> "CompressionSpec":
        """Dense gossip (bit-equal to no spec at all)."""
        return cls(kind="none",
                   ef_step=_dev_f32(1.0, resolve_device(device)))

    @classmethod
    def topk(cls, rate: float, *, ef_step: float = 0.3, wire_k: int = 0,
             device="cuda") -> "CompressionSpec":
        """Keep the ``round(rate * d)`` largest-magnitude coordinates per
        client row (ties at the k-th magnitude all survive)."""
        _check_rate(rate)
        dev = resolve_device(device)
        return cls(kind="topk", wire_k=int(wire_k), rate=_dev_f32(rate, dev),
                   ef_step=_dev_f32(ef_step, dev))

    @classmethod
    def randk(cls, rate: float, *, seed: int = 0, ef_step: float = 0.3,
              wire_k: int = 0, device="cuda") -> "CompressionSpec":
        """Bernoulli(rate) coordinate sampling scaled by 1/rate, unbiased;
        the round's draws fold the round index into ``seed``."""
        _check_rate(rate)
        dev = resolve_device(device)
        return cls(kind="randk", wire_k=int(wire_k), rate=_dev_f32(rate, dev),
                   ef_step=_dev_f32(ef_step, dev), seed=_int64(seed, dev))

    @classmethod
    def qsgd(cls, bits: float, *, seed: int = 0, ef_step: float = 0.3,
             wire_bits: int = 8, device="cuda") -> "CompressionSpec":
        """Stochastic rounding to ``2^bits - 1`` levels of each row's max
        magnitude, unbiased.  ``wire_bits`` sizes the packed word (int8
        carries levels up to 127: ``bits <= 7``)."""
        if float(bits) < 1:
            raise ValueError(f"qsgd needs bits >= 1, got {bits}")
        dev = resolve_device(device)
        return cls(kind="qsgd", wire_bits=int(wire_bits),
                   bits=_dev_f32(bits, dev), ef_step=_dev_f32(ef_step, dev),
                   seed=_int64(seed, dev))

    # -- introspection ------------------------------------------------------
    @property
    def is_stacked(self) -> bool:
        return self.ef_step is not None and self.ef_step.ndim > 0

    @property
    def n_sweep(self) -> int:
        return int(self.ef_step.shape[0]) if self.is_stacked else 1

    def point(self, s: int) -> "CompressionSpec":
        """One sweep point (identity on an unstacked spec)."""
        if not self.is_stacked:
            return self
        return dataclasses.replace(self, **{
            f: getattr(self, f)[s] for f in _LEAVES
            if getattr(self, f) is not None})

    def to(self, device) -> "CompressionSpec":
        """The same spec with its tensors on ``device``."""
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(device) for f in _LEAVES
            if getattr(self, f) is not None})


def _int64(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.int64), device=device)


def _check_rate(rate) -> None:
    r = np.asarray(rate, np.float64)
    if not (0.0 < float(r.min()) and float(r.max()) <= 1.0):
        raise ValueError(f"compression rate must be in (0, 1], got {rate}")


def check_spec(spec: CompressionSpec) -> None:
    """Host-side range checks of a (possibly stacked) spec: every rate in
    (0, 1], every ``bits >= 1`` (one host copy of each tensor)."""
    if spec.kind not in _KINDS:
        raise ValueError(f"unknown compression kind {spec.kind!r}")
    if spec.rate is not None:
        _check_rate(spec.rate.detach().cpu().numpy())
    if spec.bits is not None and float(spec.bits.min()) < 1:
        raise ValueError(f"qsgd needs bits >= 1, got {spec.bits}")


def as_mixed(spec: CompressionSpec) -> CompressionSpec:
    """The sweep form of any spec: the kind becomes the ``kind_id`` tensor.

    Unused fields get inert values (rate 1, bits 8, ef_step 1, seed 0) so
    any two mixed specs stack.  A mixed ``none`` runs the CHOCO arithmetic
    with an identity compressor and ``ef_step`` 1, which only approximates
    the dense mix; the dense path itself is an unmixed ``none`` (or no
    spec).
    """
    if spec.kind == "mixed":
        return spec
    if spec.kind not in KIND_IDS:
        raise ValueError(f"unknown compression kind {spec.kind!r}")
    dev = spec.ef_step.device
    one = _dev_f32(1.0, dev)
    return CompressionSpec(
        kind="mixed", wire_k=0, wire_bits=spec.wire_bits,
        rate=one if spec.rate is None else spec.rate,
        bits=_dev_f32(8.0, dev) if spec.bits is None else spec.bits,
        ef_step=spec.ef_step,
        seed=_int64(0, dev) if spec.seed is None else spec.seed,
        kind_id=_int64(KIND_IDS[spec.kind], dev), uniforms=spec.uniforms)


def stack_specs(specs: Sequence[CompressionSpec]) -> CompressionSpec:
    """Stack specs on a new leading sweep axis.

    Specs that agree on ``(kind, wire_k, wire_bits)`` stack as they are;
    otherwise every spec converts to the :func:`as_mixed` form first, so a
    grid of top-k rates, QSGD bits and a ``none`` baseline is one operand.
    All specs must share one ``uniforms`` hook.
    """
    specs = list(specs)
    if not specs:
        raise ValueError("need at least one CompressionSpec to stack")
    if any(s.is_stacked for s in specs):
        raise ValueError("specs are already sweep-stacked")
    if len({id(s.uniforms) for s in specs}) > 1:
        raise ValueError("stacked specs must share one uniforms hook")
    auxs = {(s.kind, s.wire_k, s.wire_bits) for s in specs}
    if len(auxs) > 1 or specs[0].kind == "mixed":
        specs = [as_mixed(s) for s in specs]
    return dataclasses.replace(specs[0], **{
        f: torch.stack([getattr(s, f) for s in specs]) for f in _LEAVES
        if getattr(specs[0], f) is not None})


def compression_of(operand) -> Optional[CompressionSpec]:
    """The spec attached to a MixSchedule / ScheduleMixer (else None)."""
    sched = getattr(operand, "schedule", operand)
    return getattr(sched, "compress", None)


def active_compression(operand) -> Optional[CompressionSpec]:
    """The attached spec when it compresses.  ``kind="none"`` returns None:
    the round program then takes the untouched dense path (bit-equal to no
    spec), not the CHOCO arithmetic with a perfect compressor."""
    spec = compression_of(operand)
    if spec is None or spec.kind == "none":
        return None
    return spec


# ---------------------------------------------------------------------------
# Row compressors (dense-shaped output); rows are every dim but the last
# ---------------------------------------------------------------------------

def _lead(v: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """A spec value against row block ``flat``: ``()`` as it is, a sweep's
    ``(S,)`` as ``(S, 1, 1)``."""
    return v.reshape(v.shape + (1,) * (flat.ndim - v.ndim)) if v.ndim else v


def _topk_rows(flat: torch.Tensor, rate: torch.Tensor) -> torch.Tensor:
    """Threshold top-k with ``k = clip(round(rate * d), 1, d)`` per point:
    the k-th largest magnitude of each row is gathered from the row's
    descending sort (no host read of k), and every entry at or above it
    survives."""
    d = flat.shape[-1]
    k = torch.clamp(torch.round(rate.to(torch.float32) * d), 1, d)
    k = _lead(k.to(torch.int64), flat)
    mag = torch.abs(flat)
    sorted_desc = torch.sort(mag, dim=-1, descending=True).values
    idx = (k - 1).expand(flat.shape[:-1] + (1,))
    thresh = torch.gather(sorted_desc, -1, idx)
    return flat * (mag >= thresh)


def _randk_rows(flat: torch.Tensor, rate: torch.Tensor,
                u: torch.Tensor) -> torch.Tensor:
    """Keep each coordinate where its uniform ``u < rate``, scaled by
    ``1 / rate``."""
    rate = _lead(rate.to(torch.float32), flat)
    keep = (u < rate).to(flat.dtype)
    return flat * keep / torch.clamp_min(rate, 1e-12).to(flat.dtype)


def _qsgd_levels(bits: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(2.0 ** bits.to(torch.float32) - 1.0, 1.0)


def _qsgd_rows(flat: torch.Tensor, bits: torch.Tensor,
               u: torch.Tensor) -> torch.Tensor:
    """Stochastic rounding of ``|x| / max|x| * s`` (``s = 2^bits - 1``
    levels) with uniforms ``u``.  The inf-norm scale makes the argmax
    coordinate land on level s exactly, so ``max|q|`` recovers the scale
    and :func:`pack_payload` round-trips quantised rows."""
    s = _lead(_qsgd_levels(bits), flat)
    f = flat.to(torch.float32)
    norm = torch.amax(torch.abs(f), dim=-1, keepdim=True)
    scaled = torch.abs(f) / torch.clamp_min(norm, 1e-12) * s
    levels = torch.floor(scaled + u)
    out = torch.sign(f) * norm * levels / s
    return out.to(flat.dtype)


def _compress_rows(spec: CompressionSpec, flat: torch.Tensor,
                   u: Optional[torch.Tensor]) -> torch.Tensor:
    if spec.kind == "none":
        return flat
    if spec.kind == "topk":
        return _topk_rows(flat, spec.rate)
    if spec.kind == "randk":
        return _randk_rows(flat, spec.rate, u)
    if spec.kind == "qsgd":
        return _qsgd_rows(flat, spec.bits, u)
    if spec.kind == "mixed":
        # every kind on every row, then a select per point (no host read
        # of kind_id); each point equals its native kind bit for bit
        kid = _lead(spec.kind_id, flat)
        out = torch.where(kid == KIND_IDS["topk"],
                          _topk_rows(flat, spec.rate), flat)
        out = torch.where(kid == KIND_IDS["randk"],
                          _randk_rows(flat, spec.rate, u), out)
        return torch.where(kid == KIND_IDS["qsgd"],
                           _qsgd_rows(flat, spec.bits, u), out)
    raise ValueError(f"unknown compression kind {spec.kind!r}")


def _needs_key(spec: CompressionSpec) -> bool:
    return spec.kind in ("randk", "qsgd", "mixed")


def compress(spec: CompressionSpec, tree: Tree, key: DrawKey | None = None,
             *, lead: int = 1) -> Tree:
    """Apply ``C`` to every leaf, row by row.

    A leaf's rows are its first ``lead`` dims: the clients ``(C, ...)``, or
    ``(S, C, ...)`` with ``lead=2`` on the sweep axis, where a stacked
    spec's ``(S,)`` values go to their points.  Randomised kinds draw each
    leaf's uniforms from ``fold_in(key, leaf index)`` (``key`` defaults to
    the spec's seed; pass a round's key from :func:`comm_round_keys` so the
    draws differ per round).
    """
    if spec.kind == "none":
        return tree
    if key is None and _needs_key(spec):
        key = DrawKey(spec.seed)
    draw = spec.uniforms or hashed_uniforms
    out = {}
    for i, (name, x) in enumerate(tree.items()):
        flat = x.reshape(tuple(x.shape[:lead]) + (-1,))
        u = None if key is None else draw(fold_in(key, i), tuple(flat.shape))
        out[name] = _compress_rows(spec, flat, u).reshape(x.shape)
    return out


# ---------------------------------------------------------------------------
# CHOCO error-feedback exchange
# ---------------------------------------------------------------------------

class CommMemory(NamedTuple):
    """Error-feedback memory of one mixed variable (leaves shaped like it).

    ``xhat`` is the public copy every client agrees on; ``s`` the running
    mix ``W xhat``, kept up to date from the compressed increments so the
    ``xhat`` table itself never has to be mixed.
    """

    xhat: Tree
    s: Tree


def comm_memory(tree: Tree) -> CommMemory:
    """Fresh (zeroed) memory shaped like one mixed variable."""
    return CommMemory(xhat={k: torch.zeros_like(v) for k, v in tree.items()},
                      s={k: torch.zeros_like(v) for k, v in tree.items()})


def comm_round_keys(spec: CompressionSpec, r: int) -> tuple:
    """``(key_x, key_y)`` for round ``r``; None for deterministic kinds."""
    if spec.seed is None or not _needs_key(spec):
        return None, None
    kr = fold_in(DrawKey(spec.seed), r)
    return fold_in(kr, 0), fold_in(kr, 1)


def choco_mix(spec: Optional[CompressionSpec], mixfn, tree: Tree,
              mem: CommMemory, key: DrawKey | None = None, *,
              lead: int = 1) -> tuple[Tree, CommMemory]:
    """One CHOCO gossip exchange with error feedback.

    ``mixfn`` is the round's mix, applied to the compressed increment q
    (the only tensor that communicates).  With ``spec`` None or ``none``
    this is the plain dense exchange, memory untouched.  ``lead`` as in
    :func:`compress`; ``ef_step`` is cast to each leaf's dtype.
    """
    if spec is None or spec.kind == "none":
        return mixfn(tree), mem
    q = compress(spec, {k: x - mem.xhat[k] for k, x in tree.items()}, key,
                 lead=lead)
    xhat = {k: mem.xhat[k] + v for k, v in q.items()}
    mq = mixfn(q)
    s = {k: mem.s[k] + mq[k] for k in q}
    out = {k: x + _lead(spec.ef_step, x).to(x.dtype) * (s[k] - xhat[k])
           for k, x in tree.items()}
    return out, CommMemory(xhat=xhat, s=s)


# ---------------------------------------------------------------------------
# Wire payloads: what a per-shard collective would carry
# ---------------------------------------------------------------------------

def wire_mode(spec: Optional[CompressionSpec]) -> Optional[str]:
    """How a spec packs on the wire: "sparse" (value/index pairs), "quant"
    (int8 words + row norms), or None (dense-shaped rows)."""
    if spec is None:
        return None
    if spec.kind in ("topk", "randk") and spec.wire_k > 0:
        return "sparse"
    if spec.kind == "qsgd":
        return "quant"
    return None


def pack_payload(spec: CompressionSpec, flat: torch.Tensor) -> tuple:
    """Pack compressed rows ``(rows, d)`` into the wire payload.

    sparse: ``(values (rows, wire_k), indices (rows, wire_k) int32)``, the
    ``wire_k`` largest magnitudes of each row (a row with more nonzeros
    than ``wire_k`` is truncated).  quant: ``(words (rows, d) int8, norms
    (rows, 1) float32)``, signed QSGD levels, exact for levels <= 127.
    An unstacked spec only.
    """
    mode = wire_mode(spec)
    if mode is None:
        raise ValueError(f"spec {spec.kind!r} (wire_k={spec.wire_k}) has no "
                         "wire payload; use the dense collective")
    with annotate("compress_pack"):
        if mode == "sparse":
            k = min(spec.wire_k, flat.shape[-1])
            idx = torch.topk(torch.abs(flat), k, dim=-1).indices
            return torch.gather(flat, -1, idx), idx.to(torch.int32)
        # the inf-norm scale of _qsgd_rows: quantised rows carry integer
        # levels of max|q|, so the round() is exact
        s = _qsgd_levels(spec.bits)
        f = flat.to(torch.float32)
        norm = torch.amax(torch.abs(f), dim=-1, keepdim=True)
        words = torch.clamp(torch.round(f / torch.clamp_min(norm, 1e-12) * s),
                            -127, 127)
        return words.to(torch.int8), norm


def unpack_payload(spec: CompressionSpec, payload: tuple, d: int,
                   dtype=torch.float32) -> torch.Tensor:
    """Invert :func:`pack_payload` back to dense-shaped ``(rows, d)``."""
    mode = wire_mode(spec)
    if mode is None:
        raise ValueError(f"spec {spec.kind!r} has no wire payload")
    with annotate("compress_unpack"):
        if mode == "sparse":
            vals, idx = payload
            flat = torch.zeros((vals.shape[0], d), dtype=dtype,
                               device=vals.device)
            return flat.scatter(-1, idx.to(torch.int64), vals.to(dtype))
        words, norm = payload
        return (words.to(torch.float32) * norm
                / _qsgd_levels(spec.bits)).to(dtype)
