from adalog_tpu_torch.quantizers.ste import round_ste, floor_ste, ceil_ste
from adalog_tpu_torch.quantizers.state import (
    QuantizerState, WeightQuantizerState, GELU_MIN,
)
from adalog_tpu_torch.quantizers.uniform import (
    uniform_quant,
    twin_uniform_quant,
)
from adalog_tpu_torch.quantizers.logarithm import (
    log2_quant,
    logsqrt2_quant,
    adalog_quant,
    make_adalog_tables,
    make_mantissa_table,
)
from adalog_tpu_torch.quantizers.adaround import (
    adaround_init_alpha,
    adaround_soft_targets,
    adaround_quant,
    adaround_hard_weight,
)
from adalog_tpu_torch.quantizers.apply import apply_quantizer, apply_weight_quantizer
