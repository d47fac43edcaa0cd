from repro_torch.data.partition import (
    dirichlet_partition,
    iid_partition,
    primary_class_partition,
)
from repro_torch.data.pipeline import ClientDataset, client_batches
from repro_torch.data.synthetic import make_image_dataset, make_token_dataset

__all__ = [
    "make_image_dataset", "make_token_dataset",
    "primary_class_partition", "dirichlet_partition", "iid_partition",
    "ClientDataset", "client_batches",
]
