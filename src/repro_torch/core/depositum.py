"""DEPOSITUM (Algorithm 1): Decentralized fEderated PrOximal Stochastic
gradIent Tracking with momentUM.

Port of ``repro/core/depositum.py``.  Per iteration, for every client i
(all clients stacked on a leading dim of every leaf):

  1. momentum      nu^{t+1} from y^t                     (OPTION I/II)
  2. prox descent  x^{t+1} = W^t prox_{alpha h}(x^t - alpha nu^{t+1})
  3. fresh grads   g^{t+1} = minibatch grad at x^{t+1}
  4. tracking      y^{t+1} = W^t (y^t + beta g^{t+1} - beta g^t)

with W^t = W only on communication steps, otherwise W^t = I.  State
variables are dicts of ``(C, ...)`` tensors named like the reference's
parameter pytree leaves (``l0.w``, ``l0.b``, ...).

With the ``fused`` knob on, steps (1)+(2) and (4) run through the two
hand-written CUDA kernels of :mod:`repro_torch.kernels.prox` (their plain
PyTorch versions on CPU tensors).

The round program also runs S configurations at once (the sweep axis of
``repro_torch.training.sweep``): ``local_then_comm_round(..., sweep=True)``
takes leaves ``(S, C, ...)`` and a Hyper of ``(S,)`` values through the
same step logic, with one ``(S, 5)`` kernel table and one grouped launch a
step for all S configurations.  The mixer is a callable, a
:class:`~repro_torch.core.mixing.MixPlan` or a round-indexed
:class:`~repro_torch.core.schedule.MixSchedule` (cohort schedules also
freeze inactive and padding rows).  A schedule carrying a
:class:`~repro_torch.core.compression.CompressionSpec` turns each comm
step into the CHOCO error-feedback exchange of
:mod:`repro_torch.core.compression`, for one configuration and on the
sweep axis; the state then carries the memory (``init(compress=...)``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.compression import (
    CommMemory,
    CompressionSpec,
    active_compression,
    choco_mix,
    comm_memory,
    comm_round_keys,
)
from repro_torch.core.gossip import Mixer, identity_mixer
from repro_torch.core.hyper import Hyper
from repro_torch.core.mixing import MixPlan, apply_mix_sweep, resolve_mixer
from repro_torch.core.momentum import MomentumKind, momentum_update
from repro_torch.core.schedule import (
    MixSchedule,
    ScheduleMixer,
    apply_schedule,
    apply_schedule_sweep,
    schedule_round_mask,
)
from repro_torch.core.prox import (
    ProxOperator,
    family_params,
    get_family,
    get_prox,
    host_array,
    host_max,
    host_min,
    prox_apply,
)
from repro_torch.kernels.prox.ops import (
    fused_local_update,
    fused_tracking,
    hyper_param_vec,
)
from repro_torch.obs.trace import annotate

Tree = dict  # name -> (C, ...) tensor

_FUSED_MODES = ("auto", "require", "off")
# floating dtypes the CUDA kernels take
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _scoped(name, fn):
    """fn under a profiler range."""
    def wrapped(*args):
        with annotate(name):
            return fn(*args)
    return wrapped


@dataclasses.dataclass(frozen=True)
class DepositumConfig:
    alpha: float = 0.05          # prox-descent step size
    beta: float = 1.0            # tracking step size (Remark 1)
    gamma: float = 0.8           # momentum coefficient in [0, 1)
    momentum: MomentumKind = "polyak"
    comm_period: int = 1         # T0: communicate when (t+1) % T0 == 0
    prox_name: str = "l1"
    prox_kwargs: dict = dataclasses.field(default_factory=lambda: {"lam": 1e-4})
    # fused-kernel policy: "auto" uses the kernels whenever this step is
    # eligible (and falls back otherwise), "require" raises on the first
    # ineligible step, "off" never fuses
    fused: str = "off"

    def fused_mode(self) -> str:
        """The fused policy ("auto" | "require" | "off"), validated."""
        if self.fused not in _FUSED_MODES:
            raise ValueError(
                f"fused must be one of {_FUSED_MODES}, got {self.fused!r}")
        return self.fused

    def hyper(self) -> Hyper:
        """Continuous hyperparameters of this config as a Hyper."""
        lam, theta = family_params(self.prox_name, self.prox_kwargs)
        return Hyper.create(alpha=self.alpha, beta=self.beta,
                            gamma=self.gamma, lam=lam, theta=theta)

    def validate(self, hyper: Hyper | None = None) -> None:
        """Host-side range checks (alpha*rho < 1, gamma in [0, 1), family
        domains).  With ``hyper=None`` they read the config's floats; a
        (possibly stacked) Hyper is checked at its worst point."""
        if self.comm_period < 1:
            raise ValueError("comm_period (T0) must be >= 1")
        self.fused_mode()  # raises on an unknown fused policy
        fam = get_family(self.prox_name)
        if hyper is None:
            alpha, gamma = self.alpha, self.gamma
            lam, theta = family_params(self.prox_name, self.prox_kwargs)
        else:
            alpha, gamma = hyper.alpha, hyper.gamma
            lam, theta = hyper.lam, hyper.theta

        fam.check_params(lam, theta)
        # elementwise worst point over (possibly stacked) sweep axes
        rho = np.asarray(fam.rho_fn(host_array(theta).astype(np.float32)))
        worst = float(np.max(host_array(alpha).astype(np.float32) * rho))
        if float(np.max(rho)) > 0.0 and worst >= 1.0:
            raise ValueError(
                f"prox of weakly convex {self.prox_name} needs "
                f"alpha*rho < 1, got max alpha*rho = {worst}"
            )
        if not (0.0 <= host_min(gamma) and host_max(gamma) < 1.0):
            raise ValueError(f"gamma must be in [0,1), got {gamma}")

    def make_prox(self) -> ProxOperator:
        prox = get_prox(self.prox_name, **self.prox_kwargs)
        prox.check_step(self.alpha)
        self.validate()
        return prox


def fused_eligibility(config: "DepositumConfig", state=None,
                      hyper: Hyper | None = None, *,
                      sweep: bool = False) -> tuple[bool, str]:
    """Can the fused kernels serve this step?

    Returns ``(ok, reason)`` with ``reason`` naming the first blocker: the
    kernels cover Polyak momentum over the l1 | mcp | scad prox chain, on
    float32 or bfloat16 state leaves.  A stacked Hyper is eligible only
    with the sweep axis (``sweep=True``: ``(S, C, ...)`` leaves, the
    kernels' ``(S, 5)`` table); the one-config step refuses it.
    """
    if config.momentum != "polyak":
        return False, (f"momentum={config.momentum!r} (kernel covers "
                       "'polyak' only)")
    if config.prox_name not in ("l1", "mcp", "scad"):
        return False, (f"prox_name={config.prox_name!r} (kernel covers "
                       "l1 | mcp | scad)")
    if state is not None:
        for tree in (state.x, state.y, state.nu, state.g):
            for leaf in tree.values():
                if leaf.dtype not in _KERNEL_DTYPES:
                    return False, (f"state leaf dtype {leaf.dtype} (kernel "
                                   "takes float32 | bfloat16)")
    if (hyper is not None and not sweep
            and torch.as_tensor(hyper.alpha).ndim > 0):
        return False, ("stacked Hyper passed directly to step (run the "
                       "sweep axis through local_then_comm_round(..., "
                       "sweep=True) or repro_torch.training.sweep)")
    return True, "eligible"


class DepositumState(NamedTuple):
    """All client variables; every leaf has leading dim = n_clients.

    ``t`` is the iteration counter, a host integer (the round loop derives
    the communication gate from it without a device sync).  ``comm`` is the
    compressed-communication memory: ``()`` for dense runs, else ``{"x":
    CommMemory, "y": CommMemory}``, one CHOCO error-feedback pair (public
    copy ``xhat``, running mix ``s``) per mixed variable, shaped like x.
    """

    x: Tree       # model parameters (per client)
    y: Tree       # gradient-tracking variable
    nu: Tree      # momentum-aggregated direction
    mu: Tree      # auxiliary momentum (Nesterov only; zeros otherwise)
    g: Tree       # last stochastic gradient estimate
    t: int        # iteration counter
    comm: Any = ()


def init(params: Tree, n_clients: int, stacked: bool = False,
         n_max: int | None = None, compress: Any = None, *,
         device="cuda") -> DepositumState:
    """Initial state on ``device``: identical x across clients, all
    auxiliaries zero.

    ``n_max`` pads the client axis beyond ``n_clients``: padding rows get
    zero-filled x; pass an active mask to :func:`step` to keep them frozen.

    ``compress`` (a CompressionSpec, or a schedule carrying one) allocates
    the zeroed CHOCO memory on ``state.comm``; None and a ``kind="none"``
    spec leave ``comm = ()``.
    """
    if n_max is not None and n_max < n_clients:
        raise ValueError(f"n_max={n_max} < n_clients={n_clients}")
    dev = resolve_device(device)
    x = {}
    for k, p in params.items():
        p = p.to(dev)
        v = p.clone() if stacked else p[None].expand(
            (n_clients,) + tuple(p.shape)).clone()
        if n_max is not None and n_max > n_clients:
            v = torch.cat([v, v.new_zeros((n_max - n_clients,) + v.shape[1:])])
        x[k] = v
    z = lambda: {k: torch.zeros_like(v) for k, v in x.items()}
    return DepositumState(x=x, y=z(), nu=z(), mu=z(), g=z(), t=0,
                          comm=initial_comm(compress, x))


def initial_comm(compress, x: Tree):
    """Zeroed error-feedback memory for both mixed variables, shaped like
    ``x``, when ``compress`` (a spec or a schedule carrying one)
    compresses; else ``()``."""
    spec = (compress if isinstance(compress, CompressionSpec)
            else active_compression(compress))
    if spec is None or spec.kind == "none":
        return ()
    return {"x": comm_memory(x), "y": comm_memory(x)}


GradFn = Callable[[Tree, Any], tuple[Tree, Any]]
# grad_fn(x_stacked, batch) -> (g_stacked, aux)


def _where(cond, new: Tree, old: Tree) -> Tree:
    return {k: torch.where(cond, new[k], old[k]) for k in new}


def _round_scalars(hp: Hyper, state: DepositumState
                   ) -> tuple[Hyper, torch.Tensor]:
    """``hp`` on the state's device, as one (5,) row ``[lam, theta, alpha,
    gamma, beta]`` (the kernels' params row) and a Hyper of 0-d views into
    it, from one host-to-device copy.  A stacked Hyper gives the (S, 5)
    table and (S,) views.

    The unfused step divides by these device scalars, so on the card each
    division is a true tensor-by-tensor division, as in the reference and
    the kernel (PyTorch's CUDA division by a CPU scalar multiplies by its
    reciprocal instead).  Range checks keep reading the host Hyper.
    """
    vec = hyper_param_vec(hp, device=next(iter(state.x.values())).device)
    lam, theta, alpha, gamma, beta = vec.unbind(-1)
    return Hyper(alpha=alpha, beta=beta, gamma=gamma, lam=lam,
                 theta=theta), vec


def step(
    state: DepositumState,
    batch: Any,
    grad_fn: GradFn,
    config: DepositumConfig,
    mixer: Mixer,
    *,
    is_comm_step: bool | torch.Tensor | None = None,
    hyper: Hyper | None = None,
    active_mask: torch.Tensor | None = None,
) -> tuple[DepositumState, Any]:
    """One DEPOSITUM iteration for all clients.

    ``mixer`` applies W over the client dim (a callable, a
    :class:`~repro_torch.core.mixing.MixPlan`, or a round-indexed
    :class:`~repro_torch.core.schedule.MixSchedule` / ``ScheduleMixer``,
    whose round is ``t // T0``).  If ``is_comm_step`` is None
    it is ``(t+1) % T0 == 0``; a bool tensor selects between the mixed and
    unmixed values.  ``hyper`` overrides the config's floats (validated by
    the caller; the config's floats are validated here).

    ``active_mask`` is the cohort gate: an (n,) 0/1 mask under which rows
    with mask 0 are frozen — every state variable keeps its previous value
    (``t`` still advances).  With a cohort schedule and no mask, the
    round's mask is drawn from the schedule's sampler.  A stacked Hyper
    raises: the sweep axis runs through :func:`local_then_comm_round`.
    """
    if hyper is None:
        config.validate()
        hp = config.hyper()
    else:
        hp = hyper
    if torch.as_tensor(hp.alpha).ndim > 0:
        _, why = fused_eligibility(config, state, hp)
        raise ValueError(
            f"fused={config.fused_mode()!r}: step runs one config: {why}")
    hp_dev, hp_vec = _round_scalars(hp, state)
    return _step(state, batch, grad_fn, config, mixer, is_comm_step, hp_dev,
                 hp_vec, active_mask)


def _release(olds, live) -> None:
    """Empty each dict of ``olds`` that is none of the dicts in ``live``:
    the donated input state lets go of trees the step has consumed."""
    for old in olds:
        if all(old is not t for t in live):
            old.clear()


def _step(state, batch, grad_fn, config, mixer, is_comm_step, hp, hp_vec,
          active_mask, donate=False):
    """:func:`step` with the hyperparameters resolved and checked: ``hp``
    and ``hp_vec`` from :func:`_round_scalars`, on the state's device.

    A (S, 5) ``hp_vec`` is the sweep axis: leaves are ``(S, C, ...)``,
    ``hp`` holds (S,) views, ``grad_fn`` and a callable mixer take
    ``(S, C, ...)`` leaves, and ``active_mask`` is (S, C).

    ``donate`` (without a mask) empties the input state's x / nu / mu
    dicts once the local update has read them, and its y / g once the
    tracking step has, so their memory is free for the gradients and the
    mixed trees (what ``jax.jit``'s buffer donation does); the values
    computed are the same.
    """
    sweep = hp_vec.ndim == 2
    # round-indexed mixers: round r = t // T0; a cohort schedule's mask
    # also gates local updates, and its mixing already masks frozen rows,
    # which lets the gate ride inside the kernels on comm steps too
    sched = (mixer.schedule if isinstance(mixer, ScheduleMixer)
             else mixer if isinstance(mixer, MixSchedule) else None)
    is_cohort_mixer = sched is not None and sched.kind == "cohort"
    comm_spec = None        # the schedule's active CompressionSpec
    key_x = key_y = None
    if sched is not None:
        r = state.t // config.comm_period
        if active_mask is None:
            active_mask = schedule_round_mask(sched, r)
        comm_spec = active_compression(sched)
        if comm_spec is not None:
            if not state.comm:
                raise ValueError(
                    "the schedule carries an active CompressionSpec but the "
                    "state has no error-feedback memory; build it with "
                    "init(..., compress=spec)")
            # the spec's scalars divide on the state's device
            comm_spec = comm_spec.to(hp_vec.device)
            key_x, key_y = comm_round_keys(comm_spec, r)
        if isinstance(mixer, MixSchedule):
            fn = apply_schedule_sweep if sweep else apply_schedule
            mixer = lambda tree, fn=fn: fn(sched, r, tree)
        else:
            mixer = lambda tree, sm=mixer: sm(tree, r)
    elif sweep and isinstance(mixer, MixPlan):
        mixer = lambda tree, plan=mixer: apply_mix_sweep(plan, tree)
    else:
        mixer, _plan = resolve_mixer(mixer)
    mixer = _scoped("gossip", mixer)
    if is_comm_step is None:
        is_comm_step = (state.t + 1) % config.comm_period == 0
    elif not isinstance(is_comm_step, torch.Tensor):
        is_comm_step = bool(is_comm_step)
    if sweep:
        # each (S,) scalar as (S, 1, ..., 1) against a leaf
        lead = lambda s, leaf: s.reshape(s.shape + (1,) * (leaf.ndim - 1))
        c = lambda s, leaf: lead(s, leaf).to(leaf.dtype)
        gamma = {k: c(hp.gamma, v) for k, v in state.nu.items()}

        def prox(tree):
            return {k: prox_apply(config.prox_name, {k: v}, lead(hp.alpha, v),
                                  lam=lead(hp.lam, v),
                                  theta=lead(hp.theta, v))[k]
                    for k, v in tree.items()}
    else:
        # scalars in each leaf's dtype so bf16 params stay bf16
        c = lambda s, leaf: torch.as_tensor(s, dtype=leaf.dtype)
        gamma = hp.gamma

        def prox(tree):
            return prox_apply(config.prox_name, tree, hp.alpha, lam=hp.lam,
                              theta=hp.theta)

    fused_mode = config.fused_mode()
    if fused_mode == "off":
        fused_ok = False
    else:
        fused_ok, why = fused_eligibility(config, state, hp, sweep=sweep)
        if fused_mode == "require" and not fused_ok:
            raise ValueError(
                f"fused='require' but the fused kernel cannot serve this "
                f"step: {why}")

    # The cohort gate rides *inside* the kernels (frozen rows written back
    # unchanged) whenever that is exactly equivalent to the reference
    # compute-then-select order: on collective-free steps, and on comm steps
    # whose mixing already masks frozen contributions (cohort schedules).
    # A generic mixer with an explicit mask keeps the outer selects, where
    # active rows may read frozen rows' hypothetical updates.
    kernel_mask = None
    if fused_ok and active_mask is not None and (
            is_comm_step is False or is_cohort_mixer):
        kernel_mask = active_mask

    if fused_ok:
        # (1)+(2) in one kernel pass per leaf:
        # nu' = g*nu + (1-g)*y; x_half = prox_{alpha h}(x - alpha nu')
        x_half, nu_next = fused_local_update(
            state.x, state.y, state.nu, hp_vec, kernel_mask,
            kind=config.prox_name)
        mu_next = state.mu
    else:
        with annotate("local_step"):
            # (1) momentum from the tracking variable
            nu_next, mu_next = momentum_update(
                config.momentum, gamma, state.nu, state.mu, state.y)
            # (2) proximal descent
            x_half = prox({k: p - c(hp.alpha, p) * nu_next[k]
                           for k, p in state.x.items()})
    donate = donate and active_mask is None
    if donate:
        _release((state.x, state.nu, state.mu), (x_half, nu_next, mu_next))

    def gossip(tree, mem, key):
        """(mixed tree, new memory): the dense mix, or the CHOCO exchange
        of a compressed schedule; a collective-free step touches neither,
        a tensor gate selects both per leaf."""
        if is_comm_step is False:
            return tree, mem
        if comm_spec is None:
            out, new_mem = mixer(tree), mem
        else:
            out, new_mem = choco_mix(comm_spec, mixer, tree, mem, key,
                                     lead=2 if sweep else 1)
        if is_comm_step is True:
            return out, new_mem
        if comm_spec is not None:
            new_mem = CommMemory(*(_where(is_comm_step, a, b)
                                   for a, b in zip(new_mem, mem)))
        return _where(is_comm_step, out, tree), new_mem

    x_next, mem_x = gossip(x_half, state.comm and state.comm["x"], key_x)
    del x_half

    # (3) fresh minibatch gradients at the *new* iterate
    g_next, aux = grad_fn(x_next, batch)

    # (4) gradient tracking with step size beta
    if fused_ok:
        y_half, g_next = fused_tracking(
            state.y, g_next, state.g, hp_vec, kernel_mask)
    else:
        with annotate("local_step"):
            y_half = {k: y + c(hp.beta, y) * (g_next[k] - state.g[k])
                      for k, y in state.y.items()}
    if donate:
        _release((state.y, state.g),
                 (y_half, g_next, x_next, nu_next, mu_next))
    y_next, mem_y = gossip(y_half, state.comm and state.comm["y"], key_y)
    del y_half
    comm_next = (state.comm if comm_spec is None
                 else {"x": mem_x, "y": mem_y})

    if active_mask is not None:
        # freeze inactive/padding rows: keep every old value where mask = 0
        # (select, not arithmetic, so active rows keep their bits exactly)
        def keep(new, old):
            return {k: torch.where(
                active_mask.reshape(active_mask.shape + (1,) * (
                    v.ndim - active_mask.ndim)) > 0, v, old[k])
                for k, v in new.items()}

        if kernel_mask is not None:
            # nu / g / the pre-mix halves are already frozen in-kernel; only
            # the mixed variables still need the post-mix select
            if is_comm_step is not False:
                x_next = keep(x_next, state.x)
                y_next = keep(y_next, state.y)
        else:
            x_next = keep(x_next, state.x)
            y_next = keep(y_next, state.y)
            nu_next = keep(nu_next, state.nu)
            mu_next = keep(mu_next, state.mu)
            g_next = keep(g_next, state.g)
        if comm_spec is not None and is_comm_step is not False:
            # frozen rows transmitted nothing: their memory must not
            # advance either
            comm_next = {v: CommMemory(*(keep(a, b) for a, b in zip(
                comm_next[v], state.comm[v]))) for v in ("x", "y")}

    new_state = DepositumState(x=x_next, y=y_next, nu=nu_next, mu=mu_next,
                               g=g_next, t=state.t + 1, comm=comm_next)
    return new_state, aux


def local_then_comm_round(
    state: DepositumState,
    batches: Any,
    grad_fn: GradFn,
    config: DepositumConfig,
    mixer: Mixer,
    *,
    hyper: Hyper | None = None,
    active_mask: torch.Tensor | None = None,
    sweep: bool = False,
    donate: bool = False,
) -> tuple[DepositumState, Any]:
    """One FL round = (T0-1) collective-free local steps + 1 gossip step.

    ``batches`` is a dict whose leaves carry a leading dim of length T0
    (one minibatch per inner iteration).  The hyperparameters are checked
    and put on the state's device once here, for the whole round.
    ``active_mask`` freezes rows for every step of the round; for a cohort
    schedule it is drawn here once a round when not given.

    ``sweep=True`` runs S configurations at once: state leaves
    ``(S, C, ...)``, ``hyper`` (S,) values (an unstacked Hyper, or None,
    broadcasts), ``grad_fn`` and a callable ``mixer`` taking ``(S, C, ...)``
    leaves (``repro_torch.training.sweep`` vmaps a client ``grad_fn``); a
    MixPlan or MixSchedule mixer may be stacked over S or shared.

    ``donate=True`` gives the input state up: its trees are emptied as the
    round consumes them (see ``_step``), which keeps one state's worth of
    memory off the peak.  Do not read the input state afterwards.
    """
    T0 = config.comm_period
    if hyper is None:
        config.validate()
        hp = config.hyper()
    else:
        config.validate(hyper)
        hp = hyper
    if sweep:
        S = next(iter(state.x.values())).shape[0]
        if torch.as_tensor(hp.alpha).ndim == 0:
            hp = Hyper(*(torch.as_tensor(v).expand(S) for v in hp))
    elif torch.as_tensor(hp.alpha).ndim > 0:
        _, why = fused_eligibility(config, state, hp)
        raise ValueError(
            f"fused={config.fused_mode()!r}: a one-config round: {why}")
    if active_mask is None:
        active_mask = schedule_round_mask(mixer, state.t // T0)
    if sweep and active_mask is not None and active_mask.ndim == 1:
        active_mask = active_mask.expand(S, -1)      # a shared schedule
    hp, hp_vec = _round_scalars(hp, state)
    take = lambda i: ({k: v[i] for k, v in batches.items()}
                      if isinstance(batches, dict) else batches[i])
    run = functools.partial(_step, donate=True) if donate else _step
    for i in range(T0 - 1):
        state, _ = run(state, take(i), grad_fn, config, identity_mixer,
                       False, hp, hp_vec, active_mask)
    return run(state, take(T0 - 1), grad_fn, config, mixer, True, hp,
               hp_vec, active_mask)


# ---------------------------------------------------------------------------
# Paper metrics (Definition 3): stationarity s(x, nu_bar)
# ---------------------------------------------------------------------------

def _client_mean(tree: Tree, weights: torch.Tensor | None = None) -> Tree:
    """Mean over the leading client dim; ``weights`` (n,) restricts it to a
    sub-population (padded rows out of the average)."""
    if weights is None:
        return {k: torch.mean(v, dim=0) for k, v in tree.items()}
    w32 = weights.to(torch.float32)
    w = w32 / torch.clamp_min(torch.sum(w32), 1e-12)
    return {k: torch.einsum("i,i...->...", w, v.to(torch.float32)).to(v.dtype)
            for k, v in tree.items()}


def _sq_norm(tree: Tree, weights: torch.Tensor | None = None) -> torch.Tensor:
    """Summed squared norm; ``weights`` (n,) masks the leading client dim."""
    if weights is None:
        return sum(torch.sum(torch.square(v.to(torch.float32)))
                   for v in tree.values())
    w = weights.to(torch.float32)

    def leaf(v):
        sq = torch.square(v.to(torch.float32))
        per_client = torch.sum(sq.reshape(sq.shape[0], -1), dim=1)
        return torch.sum(w * per_client)

    return sum(leaf(v) for v in tree.values())


def consensus_error(tree: Tree, weights: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """||J v - v||^2 summed over leaves (leading dim = clients); ``weights``
    restricts both the mean and the sum to a client sub-population."""
    mean = _client_mean(tree, weights)
    diff = {k: v - mean[k][None] for k, v in tree.items()}
    return _sq_norm(diff, weights)


def stationarity_metrics(
    state: DepositumState,
    grad_fns: dict,
    config: DepositumConfig,
    L: float = 1.0,
    *,
    hyper: Hyper | None = None,
    weights: torch.Tensor | None = None,
) -> dict[str, torch.Tensor]:
    """The three Definition-3 terms (exact grads; eval only).

    grad_fns = {
      "global_at": x_stacked -> ∇f evaluated at each client's x_i,
      "local_at":  x_stacked -> ∇f_i evaluated at x_i,
    }
    ``weights`` is the padded-axis eligibility mask (n,).
    """
    hp, _ = _round_scalars(config.hyper() if hyper is None else hyper, state)
    if weights is None:
        n = next(iter(state.x.values())).shape[0]
    else:
        n = torch.sum(weights.to(torch.float32))
    global_grads = grad_fns["global_at"](state.x)
    local_grads = grad_fns["local_at"](state.x)

    # G^alpha(x, grad) = (x - prox_{alpha h}(x - alpha grad)) / alpha
    shifted = {k: p - hp.alpha * global_grads[k] for k, p in state.x.items()}
    proxed = prox_apply(config.prox_name, shifted, hp.alpha,
                        lam=hp.lam, theta=hp.theta)
    G = {k: (p - proxed[k]) / hp.alpha for k, p in state.x.items()}
    prox_grad_sq = _sq_norm(G, weights)

    cons_x = consensus_error(state.x, weights)

    # ∇̄f(x): mean of local grads at x_i
    gbar = _client_mean(local_grads, weights)
    nubar = _client_mean(state.nu, weights)
    est_err = _sq_norm({k: gbar[k] - nubar[k] for k in gbar})
    s = (prox_grad_sq + L ** 2 * cons_x + n * est_err) / n
    return {
        "prox_grad_sq": prox_grad_sq / n,
        "consensus_x": cons_x / n,
        "grad_est_err": est_err,
        "stationarity": s,
        "consensus_y": consensus_error(state.y, weights) / n,
        "consensus_nu": consensus_error(state.nu, weights) / n,
    }
