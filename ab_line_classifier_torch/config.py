"""Config system (the port's own copy of the JAX package's ``config.py``).

The same single-``config.yml`` API as the JAX package: the same sections and
keys, loaded explicitly and passed around. A :class:`Config` is a read-only,
attribute-accessible view of the YAML dict with schema validation and typed
accessors for the hot keys. PyYAML is imported only by :func:`load_config`,
so the serving path runs where it is not installed.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Iterator, List, Mapping, Optional

# Model names accepted by TRAIN.MODEL_DEF (reference src/models/models.py:20-48;
# 'cnn0' is the registry's fallback branch at models.py:45-47).
MODEL_NAMES = (
    "cutoffvgg16",
    "vgg16",
    "mobilenetv2",
    "xception",
    "efficientnetb7",
    "custom_resnetv2",
    "cnn0",
)

EXPERIMENT_TYPES = ("single_train", "cross_validation", "hparam_search")

CLIP_ALGORITHMS = ("contiguous", "sliding_window", "average")

# Sweep variable types understood by HPARAM_SEARCH (reference
# src/train.py:281-295 translates these to W&B distributions).
SWEEP_TYPES = ("set", "int_uniform", "float_log", "float_uniform")

# WANDB is required despite the name: it carries ARTIFACT_SEED, the split
# seed every experiment path dereferences (reference config.yml:35-47; the
# reference likewise hard-reads it). Validation must reject what runtime
# rejects.
_REQUIRED_SECTIONS = ("PATHS", "WANDB", "DATA", "TRAIN", "CLIP_PREDICTION",
                      "HPARAMS")


class ConfigError(ValueError):
    """Raised when config.yml fails schema validation."""


class Config(Mapping[str, Any]):
    """Immutable, attribute-accessible nested view over the config dict."""

    __slots__ = ("_data",)

    def __init__(self, data: Dict[str, Any]):
        object.__setattr__(self, "_data", data)

    # Mapping protocol -----------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        value = self._data[key]
        if isinstance(value, dict):
            return Config(value)
        return value

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    # Attribute access: cfg.TRAIN.BATCH_SIZE -------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(f"config has no key {key!r}") from e

    def __setattr__(self, key: str, value: Any) -> None:
        raise TypeError("Config is read-only; use .replace() to derive a new one")

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._data:
            return self[key]
        return default

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self._data)

    def replace(self, **overrides: Any) -> "Config":
        """Return a new Config with (possibly nested-dict) overrides merged in."""
        data = self.to_dict()
        _deep_merge(data, overrides)
        return Config(data)

    def replace_path(self, dotted_key: str, value: Any) -> "Config":
        """Return a new Config with ``'TRAIN.BATCH_SIZE'``-style key replaced."""
        data = self.to_dict()
        parts = dotted_key.split(".")
        node = data
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
        return Config(data)

    def __repr__(self) -> str:
        return f"Config({list(self._data)})"

    # Typed convenience accessors ------------------------------------------
    @property
    def img_dim(self) -> tuple:
        return tuple(self._data["DATA"]["IMG_DIM"])

    @property
    def n_classes(self) -> int:
        return len(self._data["DATA"]["CLASSES"])

    @property
    def classes(self) -> List[str]:
        return list(self._data["DATA"]["CLASSES"])

    @property
    def model_name(self) -> str:
        return str(self._data["TRAIN"]["MODEL_DEF"]).lower()

    @property
    def batch_size(self) -> int:
        return int(self._data["TRAIN"]["BATCH_SIZE"])

    def model_hparams(self, model_name: Optional[str] = None) -> Dict[str, Any]:
        """Default hyperparameters for a model, keyed as in config (upper-case
        section names, reference ``config.yml:98-155`` / ``train.py:198-200``)."""
        name = (model_name or self.model_name).upper()
        try:
            return copy.deepcopy(self._data["HPARAMS"][name])
        except KeyError as e:
            raise ConfigError(f"HPARAMS section missing for model {name!r}") from e

    def hparam_search_space(self, model_name: Optional[str] = None) -> Dict[str, Any]:
        name = (model_name or self.model_name).upper()
        try:
            return copy.deepcopy(self._data["HPARAM_SEARCH"][name])
        except KeyError as e:
            raise ConfigError(f"HPARAM_SEARCH section missing for model {name!r}") from e


def _deep_merge(dst: Dict[str, Any], src: Mapping[str, Any]) -> None:
    for k, v in src.items():
        if isinstance(v, Mapping) and isinstance(dst.get(k), dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v) if isinstance(v, (dict, list)) else v


def validate_config(data: Dict[str, Any]) -> None:
    """Validate schema invariants that the reference assumes implicitly."""
    for section in _REQUIRED_SECTIONS:
        if section not in data:
            raise ConfigError(f"config.yml missing required section {section!r}")

    train = data["TRAIN"]
    model = str(train.get("MODEL_DEF", "")).lower()
    if model not in MODEL_NAMES:
        raise ConfigError(
            f"TRAIN.MODEL_DEF {model!r} not one of {MODEL_NAMES}"
        )
    exp = str(train.get("EXPERIMENT_TYPE", ""))
    if exp not in EXPERIMENT_TYPES:
        raise ConfigError(
            f"TRAIN.EXPERIMENT_TYPE {exp!r} not one of {EXPERIMENT_TYPES}"
        )
    try:
        batch_ok = int(train.get("BATCH_SIZE", 0)) > 0
    except (TypeError, ValueError):
        batch_ok = False
    if not batch_ok:
        raise ConfigError("TRAIN.BATCH_SIZE must be a positive integer")
    classes = data["DATA"].get("CLASSES")
    if not classes:
        raise ConfigError("DATA.CLASSES must be a non-empty list")
    if int(train.get("N_CLASSES", 0)) != len(classes):
        raise ConfigError(
            "TRAIN.N_CLASSES must equal len(DATA.CLASSES) "
            f"({train.get('N_CLASSES')} vs {len(classes)})"
        )

    img_dim = data["DATA"].get("IMG_DIM")
    if not (isinstance(img_dim, (list, tuple)) and len(img_dim) == 2):
        raise ConfigError("DATA.IMG_DIM must be [height, width]")

    if "ARTIFACT_SEED" not in data["WANDB"]:
        raise ConfigError(
            "WANDB.ARTIFACT_SEED is required (the dataset-split seed; "
            "reference config.yml:47)")

    clip = data["CLIP_PREDICTION"]
    algo = str(clip.get("ALGORITHM", ""))
    if algo not in CLIP_ALGORITHMS:
        raise ConfigError(f"CLIP_PREDICTION.ALGORITHM {algo!r} not one of {CLIP_ALGORITHMS}")

    if model.upper() not in data["HPARAMS"]:
        raise ConfigError(f"HPARAMS has no section for selected model {model.upper()!r}")

    # Sweep-space types must be known (reference train.py:281-295).
    for model_space in data.get("HPARAM_SEARCH", {}).values():
        if not isinstance(model_space, dict):
            continue
        for hname, spec in model_space.items():
            if not isinstance(spec, dict):
                continue
            stype = spec.get("TYPE")
            if stype is not None and stype not in SWEEP_TYPES:
                raise ConfigError(
                    f"HPARAM_SEARCH {hname}: TYPE {stype!r} not one of {SWEEP_TYPES}"
                )


def load_config(path: Optional[str] = None, validate: bool = True) -> Config:
    """Load ``config.yml``.

    :param path: explicit path; defaults to ``$ABLC_CONFIG`` or
        ``<cwd>/config.yml`` (the reference's convention, ``train.py:35``).
    """
    import yaml

    if path is None:
        path = os.environ.get("ABLC_CONFIG", os.path.join(os.getcwd(), "config.yml"))
    with open(path, "r") as f:
        data = yaml.safe_load(f)
    if not isinstance(data, dict):
        raise ConfigError(f"config file {path!r} did not parse to a mapping")
    if validate:
        validate_config(data)
    return Config(data)


def ensure_output_dirs(cfg: Config) -> None:
    """Create the results/ directory contract (reference config.yml:14-23)."""
    paths = cfg["PATHS"]
    for key in ("MODEL_WEIGHTS", "METRICS", "BATCH_PREDS", "EXPERIMENTS",
                "LOGS", "IMAGES", "HEATMAPS", "PARTITIONS",
                "EXPERIMENT_VISUALIZATIONS"):
        p = paths.get(key)
        if p:
            os.makedirs(p, exist_ok=True)
