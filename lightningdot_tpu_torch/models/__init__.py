"""Models of the port (counterpart of lightningdot_tpu/models)."""
from lightningdot_tpu_torch.models.bi_encoder import (  # noqa: F401
    BiEncoder, BiEncoderNllLoss, dot_product_scores)
from lightningdot_tpu_torch.models.encoder import (  # noqa: F401
    ImageEncoder, ImgEmbeddings, TextEncoder, attention_bias, init_tower_)
from lightningdot_tpu_torch.models.quantized import (  # noqa: F401
    QuantizedTextEncoder)
from lightningdot_tpu_torch.models.weights import (  # noqa: F401
    load_torch_state_dict, load_tower_, normalize_keys,
    tower_state_dict_from_jax)
