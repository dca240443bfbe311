"""The benchmark's plain reference: float32 PyTorch with TF32 off, written
from the published descriptions of the models (Keras Applications VGG16 and
MobileNetV2, the project's heads, preprocessing, augmentation, loss and
optimizers).

It imports nothing of the measured program and reads nothing the program
made: it is handed the benchmark's own inputs (uint8 frames, labels, the
seeded weights) and works out every derived quantity again (nearest-index
maps, channel order and affine, augmentation draws, dropout masks,
optimizer state). ``precision="fp8"`` gives the control: each conv and
dense input, weight and gradient rounded to float8 with a per-tensor scale,
the step below the configurations' bfloat16.
"""

import contextlib
import importlib

import torch


@contextlib.contextmanager
def exact_float32():
    """Matmuls and convolutions in IEEE float32 (TF32 off) inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def build(config: dict, precision=None) -> torch.nn.Module:
    """The reference model of ``config`` (a configuration file's object),
    from the module its ``"reference"`` key names, float32 on the CPU."""
    module = importlib.import_module(f"reference.{config['reference']}")
    model = module.Model(config)
    set_precision(model, precision)
    return model


def set_precision(model: torch.nn.Module, precision) -> None:
    """``None`` (float32) or ``"fp8"`` (the control) on every layer that
    multiplies."""
    for m in model.modules():
        if hasattr(m, "precision"):
            m.precision = precision
