from repro_torch.sharding.hints import (axis_size, get_mesh, hint, hint_spec,
                                        set_mesh)
from repro_torch.sharding.rules import (NamedSharding, PartitionSpec,
                                        batch_specs, decode_state_specs,
                                        named_shardings, param_specs)

__all__ = ["param_specs", "batch_specs", "decode_state_specs",
           "named_shardings", "PartitionSpec", "NamedSharding", "hint",
           "hint_spec", "axis_size", "set_mesh", "get_mesh"]
