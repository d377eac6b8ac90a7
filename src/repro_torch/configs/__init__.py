from repro_torch.configs.base import ModelConfig  # noqa: F401
from repro_torch.configs.xlb_microbench import (BOOKINFO,  # noqa: F401
                                                MICROBENCH, XLB_SERVICE_MODEL,
                                                ServiceGraph, chain_graph)
