from repro_torch.configs.base import (ModelConfig, SSMConfig,  # noqa: F401
                                      get_config, register, smoke_config)
from repro_torch.configs.mamba2_2_7b import MAMBA2_2_7B  # noqa: F401
from repro_torch.configs.minitron_4b import MINITRON_4B  # noqa: F401
from repro_torch.configs.xlb_microbench import (  # noqa: F401
    BANK_OF_ANTHOS, BOOKINFO, MICROBENCH, XLB_SERVICE_MODEL, ServiceGraph,
    chain_graph)
