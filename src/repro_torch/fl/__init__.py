"""FL substrate of the port: tasks, local training, server optimizers, the
synchronous round pipeline and the Auxo engine."""
from repro_torch.fl.engine import AuxoConfig, AuxoEngine, FLConfig, run_auxo, run_fl
from repro_torch.fl.task import MLPTask

__all__ = ["AuxoConfig", "AuxoEngine", "FLConfig", "MLPTask", "run_auxo", "run_fl"]
