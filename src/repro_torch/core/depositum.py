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
PyTorch versions on CPU tensors).  This slice covers dense communication
only: compressed gossip (``CompressionSpec``) and round-indexed
schedules (``MixSchedule``) arrive with their own slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.gossip import Mixer, identity_mixer
from repro_torch.core.hyper import Hyper
from repro_torch.core.mixing import resolve_mixer
from repro_torch.core.momentum import MomentumKind, momentum_update
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


def _reject_later_slices(mixer) -> None:
    name = type(mixer).__name__
    if name in ("MixSchedule", "ScheduleMixer", "CompressionSpec"):
        raise NotImplementedError(
            f"{name} is not ported yet: round-indexed schedules arrive with "
            "the schedules slice and compressed gossip with the compression "
            "slice (ROADMAP Queue 1); pass a MixPlan or a mixer callable")


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
                      hyper: Hyper | None = None) -> tuple[bool, str]:
    """Can the fused kernels serve this step?

    Returns ``(ok, reason)`` with ``reason`` naming the first blocker: the
    kernels cover Polyak momentum over the l1 | mcp | scad prox chain, on
    float32 or bfloat16 state leaves, with *scalar* hyperparameters.
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
    if hyper is not None and torch.as_tensor(hyper.alpha).ndim > 0:
        return False, ("stacked Hyper passed directly to step (the sweep "
                       "slice carries the config axis)")
    return True, "eligible"


class DepositumState(NamedTuple):
    """All client variables; every leaf has leading dim = n_clients.

    ``t`` is the iteration counter, a host integer (the round loop derives
    the communication gate from it without a device sync).  ``comm`` is the
    compressed-communication memory: always ``()`` in this slice.
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
    """
    if compress is not None:
        raise NotImplementedError(
            "compressed gossip (init(compress=...)) arrives with the "
            "compression slice (ROADMAP Queue 1)")
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
    return DepositumState(x=x, y=z(), nu=z(), mu=z(), g=z(), t=0, comm=())


GradFn = Callable[[Tree, Any], tuple[Tree, Any]]
# grad_fn(x_stacked, batch) -> (g_stacked, aux)


def _where(cond, new: Tree, old: Tree) -> Tree:
    return {k: torch.where(cond, new[k], old[k]) for k in new}


def _hp_table(hp: Hyper, state: DepositumState) -> torch.Tensor:
    """The (5,) kernel params row on the state's device."""
    return hyper_param_vec(hp, device=next(iter(state.x.values())).device)


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

    ``mixer`` applies W over the client dim (a callable or a
    :class:`~repro_torch.core.mixing.MixPlan`).  If ``is_comm_step`` is None
    it is ``(t+1) % T0 == 0``; a bool tensor selects between the mixed and
    unmixed values.  ``hyper`` overrides the config's floats (validated by
    the caller; the config's floats are validated here).

    ``active_mask`` is the cohort gate: an (n,) 0/1 mask under which rows
    with mask 0 are frozen — every state variable keeps its previous value
    (``t`` still advances).
    """
    if hyper is None:
        config.validate()
        hp = config.hyper()
    else:
        hp = hyper
    hp_vec = (_hp_table(hp, state) if config.fused_mode() != "off"
              else None)
    return _step(state, batch, grad_fn, config, mixer, is_comm_step, hp,
                 hp_vec, active_mask)


def _step(state, batch, grad_fn, config, mixer, is_comm_step, hp, hp_vec,
          active_mask):
    """:func:`step` with the hyperparameters resolved: ``hp`` on the host,
    ``hp_vec`` its kernel row already on the device (None when unfused)."""
    _reject_later_slices(mixer)
    if state.comm:
        raise NotImplementedError(
            "states with compression memory arrive with the compression "
            "slice (ROADMAP Queue 1)")
    # cohort schedules, which also admit the in-kernel gate on comm steps,
    # arrive with the schedules slice
    is_cohort_mixer = False
    mixer, _plan = resolve_mixer(mixer)
    mixer = _scoped("gossip", mixer)
    if is_comm_step is None:
        is_comm_step = (state.t + 1) % config.comm_period == 0
    # scalars in each leaf's dtype so bf16 params stay bf16
    c = lambda s, leaf: torch.as_tensor(s, dtype=leaf.dtype)

    fused_mode = config.fused_mode()
    if fused_mode == "off":
        fused_ok = False
    else:
        fused_ok, why = fused_eligibility(config, state, hp)
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
                config.momentum, hp.gamma, state.nu, state.mu, state.y)
            # (2) proximal descent
            x_half = prox_apply(
                config.prox_name,
                {k: p - c(hp.alpha, p) * nu_next[k]
                 for k, p in state.x.items()},
                hp.alpha, lam=hp.lam, theta=hp.theta)

    def gossip(tree):
        if isinstance(is_comm_step, bool):
            return mixer(tree) if is_comm_step else tree
        # tensor gate: compute the mix, select per leaf
        return _where(is_comm_step, mixer(tree), tree)

    x_next = gossip(x_half)

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
    y_next = gossip(y_half)

    if active_mask is not None:
        # freeze inactive/padding rows: keep every old value where mask = 0
        # (select, not arithmetic, so active rows keep their bits exactly)
        def keep(new, old):
            return {k: torch.where(
                active_mask.reshape(active_mask.shape
                                    + (1,) * (v.ndim - 1)) > 0, v, old[k])
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

    new_state = DepositumState(x=x_next, y=y_next, nu=nu_next, mu=mu_next,
                               g=g_next, t=state.t + 1, comm=state.comm)
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
) -> tuple[DepositumState, Any]:
    """One FL round = (T0-1) collective-free local steps + 1 gossip step.

    ``batches`` is a dict whose leaves carry a leading dim of length T0
    (one minibatch per inner iteration).  The hyperparameters are checked
    and their kernel row built once here, for the whole round.
    ``active_mask`` freezes rows for every step of the round.
    """
    _reject_later_slices(mixer)
    T0 = config.comm_period
    if hyper is None:
        config.validate()
        hp = config.hyper()
    else:
        config.validate(hyper)
        hp = hyper
    hp_vec = (_hp_table(hp, state) if config.fused_mode() != "off"
              else None)
    take = lambda i: {k: v[i] for k, v in batches.items()}
    for i in range(T0 - 1):
        state, _ = _step(state, take(i), grad_fn, config, identity_mixer,
                         False, hp, hp_vec, active_mask)
    return _step(state, take(T0 - 1), grad_fn, config, mixer, True, hp,
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
    hp = config.hyper() if hyper is None else hyper
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
