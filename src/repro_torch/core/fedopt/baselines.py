"""Federated composite-optimization baselines used by the paper's Table III.

Port of ``repro/core/fedopt/baselines.py``.  All algorithms share one
round interface so the Table III harness can swap them freely:

    alg = make_algorithm("fedmid", cfg)
    state = alg.init(params, n_clients)
    state, aux = alg.round(state, batches, grad_fn)   # batches: T0 leading dim

* **FedMiD** [Yuan, Zaheer, Reddi ICML'21] — federated mirror (here:
  proximal) descent: T0 local prox-SGD steps, then server primal averaging.
* **FedDR** [Tran Dinh et al. NeurIPS'21] — randomized Douglas-Rachford
  splitting: clients keep y_i, run an inexact prox_f step (T0 SGD steps),
  reflect, the server prox_h's the average.
* **FedADMM** [Wang, Marella, Anderson CDC'22] — primal-dual consensus
  ADMM: clients carry duals lambda_i, solve the augmented local problem
  inexactly, the server applies prox_h to the dual-corrected average.
* **DSGD / ProxDSGD** [Lian et al.'17; Zeng & Yin'18] — decentralized
  (prox-)SGD over a mixing matrix, no tracking, no momentum.

State trees are dicts of ``(C, ...)`` tensors, as the port's
``DepositumState``; ``t`` is a host int.  ``round(..., sweep=True)`` runs
S configurations at once on ``(S, C, ...)`` leaves with a Hyper of (S,)
values and a ``grad_fn`` over ``(S, C, ...)`` leaves (what
:func:`repro_torch.training.sweep.sweep_run_fedalg` drives).  The
baselines call the plain ``prox_apply``, as the reference does: no kernel
runs here.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch._device import resolve_device
from repro_torch.core.hyper import Hyper
from repro_torch.core.mixing import MixPlan, apply_mix, apply_mix_sweep
from repro_torch.core.prox import (
    ProxOperator,
    family_params,
    get_prox,
    prox_apply,
)
from repro_torch.core.schedule import (
    MixSchedule,
    apply_schedule,
    apply_schedule_sweep,
)
from repro_torch.launch.mesh import client_axis

Tree = dict  # name -> (C, ...) tensor, or (S, C, ...) on the sweep axis
GradFn = Callable[[Tree, Any], tuple[Tree, Any]]


@dataclasses.dataclass(frozen=True)
class FedAlgConfig:
    name: str = "fedmid"
    alpha: float = 0.05            # local step size
    local_steps: int = 10          # T0-equivalent
    prox_name: str = "l1"
    prox_kwargs: dict = dataclasses.field(default_factory=lambda: {"lam": 1e-4})
    eta: float = 0.5               # FedDR relaxation / ADMM rho
    W: Any = None                  # mixing matrix for decentralized algs

    def make_prox(self) -> ProxOperator:
        return get_prox(self.prox_name, **self.prox_kwargs)


class FedState(NamedTuple):
    x: Tree        # per-client iterates (leading dim n)
    aux1: Tree     # alg-specific (FedDR: y_i; FedADMM: lambda_i)
    aux2: Tree     # alg-specific (server variable z, broadcast)
    t: int         # rounds taken (host int)


def _client_mean(tree: Tree, dim: int, backend=None) -> Tree:
    """The server's mean over the client dim; over every process's rows
    when ``backend`` shards the client axis."""
    axis = client_axis(backend)
    return {k: axis.client_mean(v, dim) for k, v in tree.items()}


def _rebroadcast(tree: Tree, n: int, dim: int) -> Tree:
    return {k: v.unsqueeze(dim).expand(
        v.shape[:dim] + (n,) + v.shape[dim:]) for k, v in tree.items()}


def _first(tree: Tree) -> torch.Tensor:
    return next(iter(tree.values()))


def _step_batch(batches, i: int):
    """Step ``i`` of a round's batches: every tensor of a dict / tuple /
    list tree indexed on its leading (T0) dim."""
    if isinstance(batches, dict):
        return {k: _step_batch(v, i) for k, v in batches.items()}
    if isinstance(batches, (tuple, list)):
        return type(batches)(_step_batch(v, i) for v in batches)
    return batches[i]


def _steps(batches) -> int:
    """T0: the leading dim of the round's batches."""
    while isinstance(batches, (dict, tuple, list)):
        batches = (next(iter(batches.values())) if isinstance(batches, dict)
                   else batches[0])
    return batches.shape[0]


class _RoundScalars(NamedTuple):
    """One round's (alpha, lam, theta) on the state's device: Python floats
    from the config, or fp32 tensors (0-d, or (S,) on the sweep axis) from
    a Hyper, put there once a round."""

    alpha: Any
    lam: Any
    theta: Any
    sweep: bool

    def at(self, v, leaf: torch.Tensor):
        """``v`` against ``leaf``: an (S,) value as (S, 1, ..., 1)."""
        if self.sweep and isinstance(v, torch.Tensor):
            return v.reshape(v.shape + (1,) * (leaf.ndim - 1))
        return v


class _Algorithm:
    """Shared round interface.

    ``round(state, batches, grad_fn, hyper=None, plan=None, *,
    sweep=False)``: a ``hyper`` (a :class:`~repro_torch.core.hyper.Hyper`)
    overrides the config's alpha / lam / theta, as DEPOSITUM's does, so
    baseline grids ride the sweep engine.  ``plan`` (a MixPlan or
    MixSchedule) likewise overrides the mixing matrix for the
    *decentralized* algorithms; server-style algorithms (whose aggregation
    is a client mean, not gossip) reject it rather than silently ignore a
    topology the caller thought was in effect.  ``backend`` (a
    ``ShardMapBackend``): the state holds this process's client rows; the
    server mean reduces over the group, the gossip runs its collectives.
    """

    def __init__(self, cfg: FedAlgConfig):
        self.cfg = cfg
        self.prox = cfg.make_prox()

    def init(self, params: Tree, n_clients: int, *,
             device="cuda") -> FedState:
        """Every client starts from ``params`` (on ``device``)."""
        dev = resolve_device(device)
        x = {k: p.to(dev)[None].expand((n_clients,) + tuple(p.shape)).clone()
             for k, p in params.items()}
        return self.init_stacked(x)

    def init_stacked(self, x: Tree) -> FedState:
        """The initial state from client-stacked iterates ``x`` (``(C,
        ...)``, or ``(S, C, ...)`` on the sweep axis)."""
        return FedState(x=x, aux1={k: torch.zeros_like(v)
                                   for k, v in x.items()}, aux2=x, t=0)

    def _hp(self, hyper: Hyper | None, like: torch.Tensor,
            sweep: bool) -> _RoundScalars:
        """(alpha, lam, theta): the config's floats, or the Hyper's values
        on ``like``'s device (one copy a round)."""
        lam, theta = family_params(self.cfg.prox_name, self.cfg.prox_kwargs)
        if hyper is None:
            return _RoundScalars(self.cfg.alpha, lam, theta, False)
        vals = [torch.as_tensor(v, dtype=torch.float32).to(like.device)
                for v in (hyper.alpha, hyper.lam, hyper.theta)]
        if sweep:
            S = like.shape[0]
            vals = [v.expand(S) if v.ndim == 0 else v for v in vals]
        elif vals[0].ndim > 0:
            raise ValueError("a stacked Hyper needs the sweep axis "
                             "(round(..., sweep=True) or sweep_run_fedalg)")
        return _RoundScalars(*vals, sweep)

    def _prox(self, tree: Tree, alpha, hp: _RoundScalars) -> Tree:
        return {k: prox_apply(self.cfg.prox_name, {k: v}, hp.at(alpha, v),
                              lam=hp.at(hp.lam, v),
                              theta=hp.at(hp.theta, v))[k]
                for k, v in tree.items()}

    def _local_sgd(self, x: Tree, batches, grad_fn: GradFn, use_prox: bool,
                   hp: _RoundScalars, anchor: Tree | None = None,
                   rho: float = 0.0) -> Tree:
        """T0 (prox-)SGD steps; optional proximal-point anchor (FedDR /
        ADMM)."""
        # alpha in each leaf's dtype (an fp32 scalar must not promote bf16)
        step = {k: torch.as_tensor(hp.at(hp.alpha, v), dtype=v.dtype,
                                   device=v.device) for k, v in x.items()}
        for i in range(_steps(batches)):
            g, _ = grad_fn(x, _step_batch(batches, i))
            if rho:
                g = {k: gg + rho * (x[k] - anchor[k]) for k, gg in g.items()}
            x = {k: c - step[k] * g[k] for k, c in x.items()}
            if use_prox:
                x = self._prox(x, hp.alpha, hp)
        return x

    def _check_no_plan(self, plan) -> None:
        if plan is not None:
            raise ValueError(
                f"{type(self).__name__} aggregates via a server mean; a "
                "MixPlan/MixSchedule topology override only applies to "
                "decentralized algorithms (dsgd)")

    def round(self, state: FedState, batches, grad_fn: GradFn,
              hyper: Hyper | None = None, plan=None, *,
              sweep: bool = False, backend=None) -> tuple[FedState, dict]:
        raise NotImplementedError  # pragma: no cover - interface


class FedMiD(_Algorithm):
    def round(self, state, batches, grad_fn, hyper=None, plan=None, *,
              sweep=False, backend=None):
        self._check_no_plan(plan)
        dim = 1 if sweep else 0
        n = _first(state.x).shape[dim]
        hp = self._hp(hyper, _first(state.x), sweep)
        x = self._local_sgd(state.x, batches, grad_fn, True, hp)
        x = _rebroadcast(_client_mean(x, dim, backend), n, dim)
        return state._replace(x=x, t=state.t + 1), {}


class FedDR(_Algorithm):
    def init_stacked(self, x):
        return super().init_stacked(x)._replace(aux1=x)   # y_i = x_i

    def round(self, state, batches, grad_fn, hyper=None, plan=None, *,
              sweep=False, backend=None):
        self._check_no_plan(plan)
        dim = 1 if sweep else 0
        n = _first(state.x).shape[dim]
        hp = self._hp(hyper, _first(state.x), sweep)
        eta = self.cfg.eta
        xbar = state.aux2
        # y_i <- y_i + eta (xbar - x_i)
        y = {k: yy + eta * (xbar[k] - state.x[k])
             for k, yy in state.aux1.items()}
        # x_i ~= argmin f_i(x) + 1/(2 eta)||x - y_i||^2 (inexact: SGD, anchor)
        x = self._local_sgd(y, batches, grad_fn, False, hp, anchor=y,
                            rho=1.0 / eta)
        xhat = {k: 2.0 * xi - y[k] for k, xi in x.items()}
        zbar = self._prox(_client_mean(xhat, dim, backend), eta, hp)
        return (state._replace(x=x, aux1=y, aux2=_rebroadcast(zbar, n, dim),
                               t=state.t + 1), {})


class FedADMM(_Algorithm):
    def round(self, state, batches, grad_fn, hyper=None, plan=None, *,
              sweep=False, backend=None):
        self._check_no_plan(plan)
        dim = 1 if sweep else 0
        n = _first(state.x).shape[dim]
        hp = self._hp(hyper, _first(state.x), sweep)
        rho = self.cfg.eta
        lam, z = state.aux1, state.aux2
        # local: min f_i(x) + <lam_i, x - z> + rho/2 ||x - z||^2 (inexact)
        shifted_anchor = {k: zz - lam[k] / rho for k, zz in z.items()}
        x = self._local_sgd(state.x, batches, grad_fn, False, hp,
                            anchor=shifted_anchor, rho=rho)
        lam = {k: ll + rho * (x[k] - z[k]) for k, ll in lam.items()}
        zbar = self._prox(
            _client_mean({k: xi + lam[k] / rho for k, xi in x.items()}, dim,
                         backend),
            1.0 / rho, hp)
        return (state._replace(x=x, aux1=lam,
                               aux2=_rebroadcast(zbar, n, dim),
                               t=state.t + 1), {})


class DSGD(_Algorithm):
    """Decentralized (prox-)SGD: x <- W prox(x - alpha g); T0 local steps.

    W comes from ``cfg.W`` (a dense array, a MixPlan, or a round-indexed
    MixSchedule); ``plan=`` on ``round`` overrides it, so a stacked plan
    sweeps DSGD over topologies, and a MixSchedule puts DSGD on the same
    time-varying communication axis as DEPOSITUM (the round index is the
    state's own ``t``, which DSGD advances once per round).  A W given as
    an array is kept on the host and placed on the state's device at its
    first round there.
    """

    use_prox = True

    def __init__(self, cfg):
        super().__init__(cfg)
        if isinstance(cfg.W, (MixPlan, MixSchedule)):
            self.plan = cfg.W
        elif cfg.W is not None:
            self.plan = MixPlan.dense(cfg.W, device="cpu")
        else:
            raise ValueError("DSGD needs a mixing matrix W (array, MixPlan "
                             "or MixSchedule)")
        self._placed: dict = {}   # device -> self.plan there

    def _plan_on(self, device: torch.device):
        if device not in self._placed:
            self._placed[device] = self.plan.to(device)
        return self._placed[device]

    def round(self, state, batches, grad_fn, hyper=None, plan=None, *,
              sweep=False, backend=None):
        hp = self._hp(hyper, _first(state.x), sweep)
        x = self._local_sgd(state.x, batches, grad_fn, self.use_prox, hp)
        p = (plan if plan is not None
             else self._plan_on(_first(state.x).device))
        if backend is not None:
            mix = backend.mixer_for(p, sweep=sweep)
            x = mix(x, state.t) if isinstance(p, MixSchedule) else mix(x)
        elif isinstance(p, MixSchedule):
            x = (apply_schedule_sweep if sweep else apply_schedule)(
                p, state.t, x)
        else:
            x = (apply_mix_sweep if sweep else apply_mix)(p, x)
        return state._replace(x=x, t=state.t + 1), {}


def make_algorithm(name: str, cfg: FedAlgConfig) -> _Algorithm:
    cls = ALGORITHMS.get(name)
    if cls is None:
        raise KeyError(f"unknown algorithm {name!r}; have {sorted(ALGORITHMS)}")
    return cls(dataclasses.replace(cfg, name=name))


ALGORITHMS: dict[str, type[_Algorithm]] = {
    "fedmid": FedMiD,
    "feddr": FedDR,
    "fedadmm": FedADMM,
    "dsgd": DSGD,
}
