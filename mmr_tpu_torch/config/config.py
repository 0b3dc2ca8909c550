"""YAML config system (counterpart of ``mmr_tpu/config/config.py``),
schema- and grammar-compatible with the reference's
``common_utils.py:147-606``.

- :func:`get_default_config`: the reference's default schema and values
  (``common_utils.py:147-244``) with the JAX package's extras (``mesh``,
  ``precision``, ``seed``).
- The override grammar: ``--batch_size 16 --optimizer_lr 1e-3
  --model_arch Unet``, allow-listed per mode, ``prefix_key`` nesting for
  the ``transformations`` / ``lr_scheduler`` / ``optimizer`` / ``model``
  / ``mesh`` groups, values parsed by :func:`safe_eval`.
- :func:`get_config`'s three modes: ``training`` writes config.yaml;
  ``continue_training`` reads it, refuses changed overrides and resumes
  from ``last_model``; ``testing`` reads it, takes inference overrides and
  selects ``best_model``.

PyYAML is not used. :func:`dump_yaml` and :func:`load_yaml` write and read
the subset these files use: nested block mappings of string keys; str,
int, float, bool and null scalars; flow-style lists of scalars
(``[512, 640]``, as the JAX package's ``_FlowListDumper`` writes them);
``{}`` for an empty mapping. Scalars resolve as PyYAML's safe loader
resolves them (YAML 1.1: ``1e-05`` is a string there, ``1.0e-05`` a
float), and the writer quotes every string that would read back as
something else. The reader raises ``ValueError`` naming the line on
anything outside the subset (block sequences, anchors, multi-line
scalars, octal or sexagesimal numbers, ...).
"""

from __future__ import annotations

import ast
import copy
import math
import re
from pathlib import Path

ALLOWED_TRAINING_ARGS = [
    "transformations_scaling", "transformations_rotation",
    "transformations_gaussian_noise", "transformations_gaussian_blur",
    "transformations_low_resolution", "transformations_brightness",
    "transformations_contrast", "transformations_gamma",
    "transformations_mirror", "transformations_dummy_2d",
    "transformations_heavy_augmentation", "transformations_per_sample_spatial",
    "oversample_ratio", "oversample_strategy", "batch_size", "num_workers", "n_epochs",
    "val_plot_interval", "grad_clip_max_norm", "grad_accumulate_step",
    "seed", "precision", "mesh_data", "steps_per_epoch", "val_steps_per_epoch",
    "profile_epochs",
]
ALLOWED_TESTING_ARGS = [
    "infer_batch_size", "infer_num_workers", "sw_batch_size", "sw_overlap",
    "sw_fp32_blend", "sw_chunked",
]
FLEXIBLE_ARGS = ["lr_scheduler", "optimizer", "model"]
PREFIX_ARGS = ["transformations", "lr_scheduler", "optimizer", "model", "mesh"]


def get_default_config(n_classes: int, patch_size) -> dict:
    n_epochs = 200
    transformations = {
        "patch_size": list(patch_size),
        "scaling": True,
        "rotation": True,
        "gaussian_noise": True,
        "gaussian_blur": True,
        "low_resolution": False,
        "brightness": True,
        "contrast": True,
        "gamma": True,
        "mirror": True,
        "dummy_2d": False,
        "heavy_augmentation": False,  # Pre_Process.py:597 hard-codes False
        # the reference draws rotation / scale per sample
        # (Pre_Process.py:339-366); False shares them across a batch
        "per_sample_spatial": False,
    }
    return {
        "n_classes": n_classes,
        "transformations": transformations,
        "oversample_ratio": 0.33,
        # 'deterministic' (Pre_Process.py:787-806) | 'probabilistic' (:808-826)
        "oversample_strategy": "deterministic",
        "batch_size": 8,
        "num_workers": 8,
        "infer_batch_size": 6,
        "infer_num_workers": 4,
        "sw_batch_size": 24,
        "sw_overlap": 0.5,
        "n_epochs": n_epochs,
        "val_plot_interval": 10,
        "grad_clip_max_norm": 12,
        "grad_accumulate_step": 1,
        "lr_scheduler": {"name": "PolynomialLR", "total_iters": n_epochs, "power": 0.9},
        "optimizer": {"name": "AdamW", "lr": 1e-4},
        "model": {
            "arch": "UnetPlusPlus",
            "encoder_name": "tu-mobilenetv3_small_100",
            "encoder_weights": "imagenet",
            "in_channels": 3,
            "classes": n_classes + 1,
        },
        # fixed steps per epoch (Pre_Process.py:1131-1134)
        "steps_per_epoch": 250,
        "val_steps_per_epoch": 50,
        # extras the reference schema ignores
        "seed": 6210,
        "precision": "bf16",
        "mesh": {"data": -1, "model": 1},
    }


def safe_eval(value: str):
    """Literal parsing (``common_utils.py:344-392``): Python literals pass
    through, anything else stays a string; 'true' / 'false' / 'none'
    normalize."""
    if not isinstance(value, str):
        return value
    low = value.strip().lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if low in ("none", "null"):
        return None
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


def check_and_convert_user_config_args(args: list[str] | None, mode: str) -> dict | None:
    """``['--batch_size','16','--optimizer_lr','0.001']`` ->
    ``{'batch_size': 16, 'optimizer': {'lr': 0.001}}``, allow-listed
    (``common_utils.py:395-490``)."""
    if not args:
        return None
    stripped = [a.lstrip("-") for a in args]
    if len(stripped) % 2 != 0:
        raise ValueError(f"override args must come in --key value pairs, got {args}")
    flat = {stripped[i]: safe_eval(stripped[i + 1]) for i in range(0, len(stripped), 2)}

    out: dict = {}
    for arg, value in flat.items():
        wrong_for_training = (
            mode == "training" and arg not in ALLOWED_TRAINING_ARGS
            and not any(item in arg for item in FLEXIBLE_ARGS)
        )
        wrong_for_testing = mode == "testing" and arg not in ALLOWED_TESTING_ARGS
        if wrong_for_training or wrong_for_testing:
            raise KeyError(
                f"Argument '{arg}' is not an allowed argument. "
                f"Valid training arguments: {ALLOWED_TRAINING_ARGS}. "
                f"Valid inference arguments: {ALLOWED_TESTING_ARGS}. "
                f"Valid flexible arguments: {[i + '_*' for i in FLEXIBLE_ARGS]}.")
        for prefix in PREFIX_ARGS:
            if arg.startswith(prefix + "_"):
                out.setdefault(prefix, {})[arg[len(prefix) + 1:]] = value
                break
        else:
            out[arg] = value
    return out


def add_user_config_args(config: dict, config_args: dict | None) -> dict:
    if not config_args:
        return config
    for key, value in config_args.items():
        if isinstance(value, dict):
            config.setdefault(key, {})
            config[key].update(value)
        else:
            config[key] = value
    # dependent-field sync (common_utils.py:337-339)
    if "n_epochs" in config_args and config.get("lr_scheduler", {}).get("name") == "PolynomialLR":
        config["lr_scheduler"]["total_iters"] = config["n_epochs"]
    return config


# ------------------------------------------------------------ YAML subset

_NULL = {"~", "null", "Null", "NULL", ""}
_BOOL = {**{w: True for w in ("yes", "Yes", "YES", "true", "True", "TRUE",
                              "on", "On", "ON")},
         **{w: False for w in ("no", "No", "NO", "false", "False", "FALSE",
                               "off", "Off", "OFF")}}
_INT = re.compile(r"[-+]?(0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?([0-9]+\.[0-9]*|\.[0-9]+)([eE][-+][0-9]+)?")
_SPECIAL_FLOAT = {".inf": math.inf, ".Inf": math.inf, ".INF": math.inf,
                  "+.inf": math.inf, "+.Inf": math.inf, "+.INF": math.inf,
                  "-.inf": -math.inf, "-.Inf": -math.inf, "-.INF": -math.inf,
                  ".nan": math.nan, ".NaN": math.nan, ".NAN": math.nan}
# plain strings the subset takes: they resolve to str in YAML 1.1 and in
# this reader, and need no quoting in a block or a flow context
_PLAIN_STR = re.compile(r"[A-Za-z_/][A-Za-z0-9_./+\-]*(:[A-Za-z0-9_./+\-]+)*")
# the reader also takes the single inner spaces PyYAML leaves plain
_PLAIN_READ = re.compile(r"[A-Za-z_/][A-Za-z0-9_./+\-]*([: ][A-Za-z0-9_./+\-]+)*")
# plain scalars that YAML 1.1 reads as something this subset does not take
_UNTAKEN = re.compile(r"[-+]?(0[0-7_]+|0x[0-9a-fA-F_]+|0b[01_]+|[0-9][0-9_]*(:[0-5]?[0-9])+"
                      r"(\.[0-9_]*)?|[0-9][0-9_]*|[0-9][0-9_]*\.[0-9_]*([eE][-+][0-9]+)?)"
                      r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|=|<<")


def _scalar_text(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        s = repr(v).lower()
        if "." not in s and "e" in s:   # PyYAML's represent_float
            s = s.replace("e", ".0e", 1)
        return s
    if isinstance(v, str):
        if _PLAIN_STR.fullmatch(v) and v not in _NULL and v not in _BOOL:
            return v
        return "'" + v.replace("'", "''") + "'"
    raise ValueError(f"the YAML subset has no scalar of type {type(v).__name__}")


def dump_yaml(data: dict) -> str:
    """``data`` (a dict of the subset) as block-style YAML text, keys in
    their order, lists in flow style."""
    if not isinstance(data, dict):
        raise ValueError("the top level must be a mapping")
    lines: list[str] = []

    def emit(d: dict, indent: int):
        for k, v in d.items():
            if not isinstance(k, str):
                raise ValueError(f"the YAML subset has string keys only, got {k!r}")
            key = " " * indent + _scalar_text(k) + ":"
            if isinstance(v, dict):
                if v:
                    lines.append(key)
                    emit(v, indent + 2)
                else:
                    lines.append(key + " {}")
            elif isinstance(v, (list, tuple)):
                for x in v:
                    if isinstance(x, (dict, list, tuple)):
                        raise ValueError(f"{k}: lists hold scalars only in the YAML subset")
                lines.append(key + " [" + ", ".join(_scalar_text(x) for x in v) + "]")
            else:
                lines.append(key + " " + _scalar_text(v))

    emit(data, 0)
    return "".join(line + "\n" for line in lines)


class _Line:
    def __init__(self, no: int, text: str):
        self.no, self.text = no, text

    def fail(self, why: str):
        raise ValueError(f"config YAML line {self.no}: {why}: {self.text!r}")


def _unquote(s: str, line: _Line) -> tuple[str, str]:
    """A quoted scalar at the start of ``s`` -> (its value, the rest)."""
    q = s[0]
    i, out = 1, []
    while i < len(s):
        c = s[i]
        if q == "'" and c == "'":
            if s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), s[i + 1:]
        if q == '"' and c == "\\":
            esc = {'"': '"', "\\": "\\", "n": "\n", "t": "\t", "/": "/"}.get(s[i + 1:i + 2])
            if esc is None:
                line.fail("escape outside the subset")
            out.append(esc)
            i += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), s[i + 1:]
        out.append(c)
        i += 1
    line.fail("unterminated quoted scalar")


def _strip_comment(s: str, line: _Line) -> str:
    """``s`` without a trailing `` # comment`` outside quotes."""
    i, quote = 0, None
    while i < len(s):
        c = s[i]
        if quote:
            if c == quote:
                if quote == "'" and s[i + 1:i + 2] == "'":
                    i += 2
                    continue
                quote = None
            elif quote == '"' and c == "\\":
                i += 1
        elif c in "'\"" and (i == 0 or s[i - 1] in " [,:"):
            quote = c
        elif c == "#" and (i == 0 or s[i - 1] == " "):
            return s[:i].rstrip()
        i += 1
    return s.rstrip()


def _plain(s: str, line: _Line):
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if s in _SPECIAL_FLOAT:
        return _SPECIAL_FLOAT[s]
    if _INT.fullmatch(s):
        return int(s)
    if _FLOAT.fullmatch(s):
        return float(s)
    if _UNTAKEN.fullmatch(s):
        line.fail("a number form outside the subset")
    if _PLAIN_READ.fullmatch(s):
        return s
    line.fail("a plain scalar outside the subset (quote it)")


def _value(s: str, line: _Line):
    """One scalar, a flow list of scalars or ``{}``."""
    if s.startswith(("'", '"')):
        v, rest = _unquote(s, line)
        if rest.strip():
            line.fail("text after a quoted scalar")
        return v
    if s == "{}":
        return {}
    if s.startswith("["):
        if not s.endswith("]"):
            line.fail("a flow list must close on its line")
        body, items = s[1:-1].strip(), []
        while body:
            if body.startswith(("'", '"')):
                v, body = _unquote(body, line)
                body = body.strip()
            else:
                j = body.find(",")
                j = len(body) if j < 0 else j
                tok = body[:j].strip()
                if not tok or tok[0] in "[{":
                    line.fail("a flow list holds scalars only")
                v, body = _plain(tok, line), body[j:]
            items.append(v)
            if body.startswith(","):
                body = body[1:].strip()
                if not body:
                    line.fail("a trailing comma in a flow list")
            elif body:
                line.fail("a flow list item runs on after its value")
        return items
    if s[0] in "{&*!|>-?%@`" and not (_INT.fullmatch(s) or _FLOAT.fullmatch(s)
                                      or s in _SPECIAL_FLOAT):
        line.fail("a YAML form outside the subset")
    return _plain(s, line)


def load_yaml(text: str):
    """Read YAML text of the subset :func:`dump_yaml` writes (and PyYAML's
    block style of such dicts). Returns a dict, or None for an empty
    document; raises ``ValueError`` naming the line on anything else."""
    lines = []
    for no, raw in enumerate(text.splitlines(), 1):
        line = _Line(no, raw)
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            line.fail("a tab in the indentation")
        body = _strip_comment(raw.strip(), line)
        if body:
            line.text = raw
            lines.append((len(raw) - len(raw.lstrip(" ")), body, line))
    if not lines:
        return None
    root: dict = {}
    stack = [(0, root)]           # (indent of the mapping's keys, mapping)
    pending = None                # (indent, key, parent) of a "key:" line
    for indent, body, line in lines:
        if pending is not None:
            p_indent, p_key, p_parent = pending
            pending = None
            if indent > p_indent:
                child: dict = {}
                p_parent[p_key] = child
                stack.append((indent, child))
            else:
                p_parent[p_key] = None
        while len(stack) > 1 and indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            line.fail("indentation that matches no open mapping")
        mapping = stack[-1][1]
        if body.startswith(("- ", "---", "...")) or body == "-":
            line.fail("a form outside the subset (block sequence or document marker)")
        if body.startswith(("'", '"')):
            key, rest = _unquote(body, line)
            if not rest.startswith(":"):
                line.fail("a key must be followed by ':'")
            rest = rest[1:]
        else:
            j = body.find(": ")
            if j < 0 and body.endswith(":"):
                j = len(body) - 1
            if j < 0:
                line.fail("not a 'key: value' line")
            key, rest = body[:j], body[j + 1:]
            if not _PLAIN_READ.fullmatch(key) or key in _NULL or key in _BOOL:
                line.fail("a key outside the subset")
        if rest and not rest.startswith(" "):
            line.fail("no space after ':'")
        if key in mapping:
            line.fail(f"duplicate key {key!r}")
        rest = rest.strip()
        if rest:
            mapping[key] = _value(rest, line)
        else:
            mapping[key] = None
            pending = (indent, key, mapping)
    return root


# ------------------------------------------------------------ files

def create_config(config: dict, results_path: str | Path) -> Path:
    """Write ``<results_path>/config.yaml`` with flow-style lists
    (``common_utils.py:247-295``)."""
    path = Path(results_path)
    path.mkdir(parents=True, exist_ok=True)
    out = path / "config.yaml"
    out.write_text(dump_yaml(config))
    return out


def read_config(path: str | Path) -> dict:
    """A ``config.yaml`` read back through :func:`load_yaml`."""
    return load_yaml(Path(path).read_text())


def get_config(
    dataset_path: str,
    results_path: str,
    mode: str,
    config_args: dict | None = None,
    n_classes: int | None = None,
    patch_size=None,
    progress_bar: bool = False,
) -> dict:
    config_path = Path(results_path) / "config.yaml"
    if mode == "training":
        config = get_default_config(n_classes, patch_size)
        config["dataset_path"] = str(dataset_path)
        config["results_path"] = str(results_path)
        config["progress_bar"] = bool(progress_bar)
        config["patch_size"] = list(patch_size)
        config = add_user_config_args(config, config_args)
        config["load_model_path"] = None
        create_config(config, results_path)
        return config

    if not config_path.exists():
        raise FileNotFoundError(str(config_path))
    config = read_config(config_path)
    print(f"Using configuration file: {config_path}")
    config["results_path"] = str(results_path)

    if mode == "continue_training":
        user_config = add_user_config_args(copy.deepcopy(config), config_args)
        different = [(k, config.get(k), user_config.get(k))
                     for k in user_config if config.get(k) != user_config.get(k)]
        assert not different, (
            "continue_training forbids config changes "
            f"(common_utils.py:556-572); differing: {different}")
        config["load_model_path"] = str(Path(results_path) / "checkpoints" / "last_model")
        return config

    if mode == "testing":
        user_config = add_user_config_args(copy.deepcopy(config), config_args)
        changed = [(k, config.get(k), user_config.get(k))
                   for k in user_config if config.get(k) != user_config.get(k)]
        for key, _, new in changed:
            print(f"Overriding {key} -> {new}")
        config = user_config
        config["load_model_path"] = str(Path(results_path) / "checkpoints" / "best_model")
        return config

    raise ValueError(f"mode must be training/continue_training/testing, got {mode!r}")
