"""Training substrate: optimizers, step factory, checkpoint, elastic mesh,
gradient compression, straggler watchdog (the port of ``repro.train``)."""
from repro_torch.train import checkpoint  # noqa: F401
from repro_torch.train.compression import (  # noqa: F401
    compressed_psum,
    init_residual,
    make_ddp_train_step,
)
from repro_torch.train.elastic import MeshPlan, build_mesh, plan_mesh, simulate_failure  # noqa: F401
from repro_torch.train.optimizer import Optimizer, make_optimizer  # noqa: F401
from repro_torch.train.step import make_train_step  # noqa: F401
from repro_torch.train.straggler import StragglerEvent, StragglerWatchdog  # noqa: F401
