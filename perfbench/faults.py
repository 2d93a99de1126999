"""Faults planted in the program under test, for the checks that show the
comparison catches them (``calibrate.py`` on the chip, the CPU tests).
Each is a ``program_hook`` of ``perfbench.kinds.train.run``: it changes
the built trainer, or a function of the round program, and returns the
undo.  The benchmark's own runs plant none.

* ``unchanged``: the momentum + prox update hands back x and nu as they
  were, so the parameters never move;
* ``half_batch``: every client's gradient and loss over the first half of
  its batch only (the mean over the rest);
* ``no_mix``: the gossip step leaves the clients unmixed;
* ``altered``: client 0's answer doubled where it is produced: every leaf
  of its gradient.
"""
from __future__ import annotations


def _unchanged(trainer):
    import repro_torch.core.depositum as dep

    real = dep.fused_local_update
    dep.fused_local_update = lambda x, y, nu, *a, **k: (x, nu)

    def undo():
        dep.fused_local_update = real
    return undo


def _half_batch(trainer):
    inner = trainer._grad_fn

    def grad_fn(x, batch):
        half = {k: v[:, : v.shape[1] // 2] for k, v in batch.items()}
        return inner(x, half)

    trainer._grad_fn = grad_fn
    return lambda: None


def _no_mix(trainer):
    trainer.mixer = lambda tree: tree
    return lambda: None


def _altered(trainer):
    inner = trainer._grad_fn

    def grad_fn(x, batch):
        g, aux = inner(x, batch)
        for v in g.values():
            v[0].mul_(2)
        return g, aux

    trainer._grad_fn = grad_fn
    return lambda: None


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "no_mix": _no_mix, "altered": _altered}
