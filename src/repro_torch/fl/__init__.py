from repro_torch.fl.client import CNNTrainer, build_fl_clients
from repro_torch.fl.metrics import RunHistory
from repro_torch.fl.network import WirelessNetwork

__all__ = ["WirelessNetwork", "CNNTrainer", "build_fl_clients",
           "RunHistory"]
