"""Partition rules and the activation constraint over a mesh (port of
``repro/sharding``)."""
from repro_torch.sharding.rules import (batch_spec, cache_shardings,
                                        param_shardings, opt_state_shardings,
                                        spec_for_param)
