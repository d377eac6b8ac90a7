"""Architecture configs (twin of ``repro/configs/__init__.py``): the assigned
pool and the paper's own topologies; importing each module registers its
config, so ``get_config`` and ``list_configs`` know every arch the
reference does."""

from repro_torch.configs.base import (  # noqa: F401
    SHAPES, MLAConfig, ModelConfig, MoEConfig, ShapeConfig, SSMConfig,
    get_config, list_configs, register, shape_applicable, smoke_config)
from repro_torch.configs.granite_20b import GRANITE_20B  # noqa: F401
from repro_torch.configs.internlm2_20b import INTERNLM2_20B  # noqa: F401
from repro_torch.configs.yi_34b import YI_34B  # noqa: F401
from repro_torch.configs.minitron_4b import MINITRON_4B  # noqa: F401
from repro_torch.configs.deepseek_v2_236b import (  # noqa: F401
    DEEPSEEK_V2_236B)
from repro_torch.configs.arctic_480b import ARCTIC_480B  # noqa: F401
from repro_torch.configs.whisper_large_v3 import (  # noqa: F401
    WHISPER_LARGE_V3)
from repro_torch.configs.chameleon_34b import CHAMELEON_34B  # noqa: F401
from repro_torch.configs.mamba2_2_7b import MAMBA2_2_7B  # noqa: F401
from repro_torch.configs.jamba_v0_1_52b import JAMBA_V0_1_52B  # noqa: F401
from repro_torch.configs.xlb_microbench import (  # noqa: F401
    BANK_OF_ANTHOS, BOOKINFO, MICROBENCH, XLB_SERVICE_MODEL, ServiceGraph,
    chain_graph)

#: the reference's assigned architectures (``repro/configs/__init__.py``)
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
