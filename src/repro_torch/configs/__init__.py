from repro_torch.configs.base import (ModelConfig, SSMConfig,  # noqa: F401
                                      get_config, register, smoke_config)
from repro_torch.configs.mamba2_2_7b import MAMBA2_2_7B  # noqa: F401
from repro_torch.configs.minitron_4b import MINITRON_4B  # noqa: F401
from repro_torch.configs.xlb_microbench import (  # noqa: F401
    BANK_OF_ANTHOS, BOOKINFO, MICROBENCH, XLB_SERVICE_MODEL, ServiceGraph,
    chain_graph)

#: the reference's assigned architectures (``repro/configs/__init__.py``);
#: ``get_config`` knows the ported families' (minitron-4b, mamba2-2.7b)
ASSIGNED_ARCHS = [
    "granite-20b",
    "internlm2-20b",
    "yi-34b",
    "minitron-4b",
    "deepseek-v2-236b",
    "arctic-480b",
    "whisper-large-v3",
    "chameleon-34b",
    "mamba2-2.7b",
    "jamba-v0.1-52b",
]
#: the encoder-decoder ones, which the serving loop cannot drive
ENCDEC_ARCHS = ("whisper-large-v3",)
