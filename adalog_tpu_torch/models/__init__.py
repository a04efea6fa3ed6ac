from adalog_tpu_torch.models.layers import (
    LinearSite, ConvSite, MatMulSite,
    qlinear, qconv2d, qmatmul, layer_norm,
)
from adalog_tpu_torch.models.eva import (
    EvaConfig, EvaTransformer, eva_forward, eva_init,
)
from adalog_tpu_torch.models.vit import (
    ViTConfig, VisionTransformer, vit_forward, vit_init,
)
from adalog_tpu_torch.models.zoo import MODEL_ZOO, build_model, model_spec
