from ab_line_classifier_torch.models.common import ModelSpec  # noqa: F401
from ab_line_classifier_torch.models.preprocess import (  # noqa: F401
    get_preprocess_fn,
    preprocess_affine_params,
)
from ab_line_classifier_torch.models.registry import (  # noqa: F401
    MODEL_NAMES,
    build_model,
    get_model,
    get_preprocess_mode,
)
