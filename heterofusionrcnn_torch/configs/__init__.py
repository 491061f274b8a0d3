from heterofusionrcnn_torch.configs.config import (  # noqa: F401
    DatasetConfig,
    EvalConfig,
    InputConfig,
    LossConfig,
    MiniBatchConfig,
    ModelConfig,
    PipelineConfig,
    RcnnConfig,
    RpnConfig,
    TrainConfig,
)
