"""SFPrompt core, ported: the three-way split model, the training round
(losses, EL2N pruning, local-loss update, FedAvg, the three-phase
protocol), the FL and SFL baselines and the communication cost model."""
from repro_torch.core.protocol import (ProtocolConfig,  # noqa: F401
                                       SFPromptTrainer)
from repro_torch.core.split import SplitConfig, SplitModel  # noqa: F401
from repro_torch.core.baselines import (BaselineConfig,  # noqa: F401
                                        FLTrainer, SFLTrainer)
