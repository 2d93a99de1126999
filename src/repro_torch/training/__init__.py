"""The trainer, its backends and checkpoints, and the sweep engine."""
from repro_torch.training.backends import (  # noqa: F401
    LATENCY_BYTES_FLOOR,
    ExecutionBackend,
    StackedVmapBackend,
    SweepBackend,
    get_backend,
    suggest_backend,
    suggest_backend_name,
)
from repro_torch.training.checkpoint import (  # noqa: F401
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.training.sweep import (  # noqa: F401
    broadcast_batches,
    make_sweep_round,
    stack_rounds,
    sweep_batch_iter,
    sweep_init,
    sweep_run,
    sweep_run_sequential,
)
from repro_torch.training.train_loop import (  # noqa: F401
    FederatedTrainer,
    TrainerConfig,
    classification_batch_iterator,
    lm_batch_iterator,
)
