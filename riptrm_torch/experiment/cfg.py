"""Config system: YAML + ${...} interpolation + multirun sweeps.

The port's own copy of ``riptrm_tpu/experiment/cfg.py`` (the reference's
Hydra usage replaced by a hand-rolled loader).  The schema of the YAML files
is the shared one under ``configs/``: ``problem_name``, ``problem_instance``,
``problem_initialpoint``, ``solver_name``, ``solver_option.common`` +
``solver_option.<SOLVER>`` overrides, ``output_path`` with ``${...}``
interpolation, and a ``sweeper.params`` block for multirun.

CLI override grammar (Hydra-like): ``key=value`` (dots for nesting); with
``-m``/``--multirun``, comma-separated values sweep the cross product.

The files are read by ``safe_load`` below, a reader for the YAML subset the
shipped configs use (block mappings, flow lists, quoted and plain scalars,
comments) with PyYAML's YAML 1.1 scalar rules, so the package does not need
PyYAML; it raises on any other YAML construct.
"""

from __future__ import annotations

import itertools
import re
from typing import Any, Dict, List

_INTERP = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


class Config(dict):
    """Dict with attribute access (cfg.problem_name) and nested lookup."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return Config(v) if isinstance(v, dict) else v

    def get_path(self, dotted: str, default=None):
        cur: Any = self
        for part in dotted.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return default
            cur = cur[part]
        return cur

    def set_path(self, dotted: str, value):
        parts = dotted.split(".")
        cur = self
        for part in parts[:-1]:
            cur = cur.setdefault(part, {})
        cur[parts[-1]] = value


# ----------------------------------------------------------------------
# The YAML subset reader (PyYAML's ``safe_load`` on the configs' subset)
# ----------------------------------------------------------------------
_BOOL = {
    **dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
    **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"),
                    False),
}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_INT_BASE = re.compile(r"^([-+]?)(0b[01_]+|0x[0-9a-fA-F_]+|0[0-7_]+)$")
_FLOAT = re.compile(
    r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?)$"
)
_INF = re.compile(r"^([-+]?)\.(?:inf|Inf|INF)$")
_NAN = re.compile(r"^\.(?:nan|NaN|NAN)$")
_SEXAGESIMAL = re.compile(r"^[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(\.[0-9_]*)?$")


def _plain_scalar(s: str):
    """YAML 1.1 implicit typing of a plain scalar, as PyYAML resolves it."""
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.match(s):
        return int(s.replace("_", ""))
    m = _INT_BASE.match(s)
    if m:
        sign = -1 if m.group(1) == "-" else 1
        body = m.group(2).replace("_", "")
        base = 2 if body[:2] == "0b" else 16 if body[:2] == "0x" else 8
        return sign * int(body[2:] if base != 8 else body, base)
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    m = _INF.match(s)
    if m:
        return float("-inf") if m.group(1) == "-" else float("inf")
    if _NAN.match(s):
        return float("nan")
    if (_SEXAGESIMAL.match(s) or s[:1] in "&*!|>{@`%" or s in ("-", "?")
            or s.startswith(("- ", "? "))):
        raise ValueError(f"YAML construct outside the configs' subset: {s!r}")
    return s


def _quoted(s: str, i: int):
    """The quoted scalar starting at s[i] -> (value, index after it)."""
    q = s[i]
    out, j = [], i + 1
    while j < len(s):
        c = s[j]
        if q == "'" and c == "'":
            if s[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            esc = s[j + 1:j + 2]
            out.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\", "/": "/"}.get(esc))
            if out[-1] is None:
                raise ValueError(f"unsupported escape \\{esc} in {s!r}")
            j += 2
            continue
        if q == '"' and c == '"':
            return "".join(out), j + 1
        out.append(c)
        j += 1
    raise ValueError(f"unterminated quoted scalar in {s!r}")


def _flow(s: str, i: int):
    """A flow list or scalar starting at s[i] -> (value, index after it)."""
    while i < len(s) and s[i] == " ":
        i += 1
    if i < len(s) and s[i] == "[":
        items, i = [], i + 1
        while True:
            while i < len(s) and s[i] == " ":
                i += 1
            if i < len(s) and s[i] == "]":
                return items, i + 1
            item, i = _flow(s, i)
            items.append(item)
            while i < len(s) and s[i] == " ":
                i += 1
            if i < len(s) and s[i] == ",":
                i += 1
            elif i < len(s) and s[i] == "]":
                return items, i + 1
            else:
                raise ValueError(f"malformed flow list: {s!r}")
    if i < len(s) and s[i] in "'\"":
        return _quoted(s, i)
    j = i
    while j < len(s) and s[j] not in ",]":
        j += 1
    return _plain_scalar(s[i:j].strip()), j


def _value(text: str):
    """A whole value (after ``key:`` or a CLI ``=``): flow list, quoted or
    plain scalar; anything left over is an error."""
    text = text.strip()
    if text[:1] in ("[", "'", '"'):
        value, end = _flow(text, 0)
        if text[end:].strip():
            raise ValueError(f"trailing text after a YAML value: {text!r}")
        return value
    if text[:1] == "{":
        raise ValueError(f"YAML construct outside the configs' subset: {text!r}")
    return _plain_scalar(text)


def _strip_comment(line: str) -> str:
    """The line without its comment (a '#' at its start or after a blank,
    outside quotes)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"":
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def safe_load(text: str):
    """``yaml.safe_load`` on the configs' subset: a block mapping (nested by
    indentation) of flow lists and scalars; None for an empty document."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip() or line.strip() in ("---", "..."):
            continue
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise ValueError(f"tab indentation: {raw!r}")
        lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    pos = 0

    def block(indent):
        nonlocal pos
        out: Dict[str, Any] = {}
        while pos < len(lines):
            ind, body = lines[pos]
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"unexpected indentation at {body!r}")
            if body.startswith(("- ", "? ")) or body == "-":
                raise ValueError(f"YAML construct outside the configs' subset: {body!r}")
            if body[:1] in "'\"":
                key, end = _quoted(body, 0)
                rest = body[end:].lstrip()
                if not rest.startswith(":"):
                    raise ValueError(f"not a mapping entry: {body!r}")
                rest = rest[1:]
            else:
                m = re.match(r"^([^:]+?)\s*:(\s|$)", body)
                if m is None:
                    raise ValueError(f"not a mapping entry: {body!r}")
                key, rest = _plain_scalar(m.group(1)), body[m.end():]
            pos += 1
            if rest.strip():
                out[key] = _value(rest)
            elif pos < len(lines) and lines[pos][0] > indent:
                out[key] = block(lines[pos][0])
            else:
                out[key] = None
        return out

    doc = block(lines[0][0])
    if pos != len(lines):
        raise ValueError(f"unexpected dedent at {lines[pos][1]!r}")
    return doc


# ----------------------------------------------------------------------
# Loading, overrides, interpolation and sweeps (the JAX module's semantics)
# ----------------------------------------------------------------------
_NUMBER = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")


def _coerce(value):
    """YAML 1.1 reads '1e-2' as a string; coerce numeric-looking strings to
    numbers, recursively (what OmegaConf/Hydra do)."""
    if isinstance(value, str) and _NUMBER.match(value):
        f = float(value)
        return int(f) if f.is_integer() and ("e" not in value.lower() and "." not in value) else f
    if isinstance(value, dict):
        return {k: _coerce(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_coerce(v) for v in value]
    return value


def _parse_scalar(s: str):
    """YAML-ish scalar parsing for CLI override values."""
    return _coerce(_value(s))


def _interpolate(value, root: Config):
    if isinstance(value, str):
        def repl(match):
            v = root.get_path(match.group(1))
            return str(v) if v is not None else match.group(0)

        # full-string reference keeps native type
        m = _INTERP.fullmatch(value)
        if m is not None:
            v = root.get_path(m.group(1))
            return v if v is not None else value
        return _INTERP.sub(repl, value)
    if isinstance(value, dict):
        return {k: _interpolate(v, root) for k, v in value.items()}
    if isinstance(value, list):
        return [_interpolate(v, root) for v in value]
    return value


def _read(path: str):
    with open(path) as f:
        return safe_load(f.read()) or {}


def load_config(
    path: str, overrides: List[str] | None = None, interpolate: bool = True
) -> Config:
    cfg = Config(_coerce(_read(path)))
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"Override '{ov}' must be key=value")
        k, v = ov.split("=", 1)
        cfg.set_path(k, _parse_scalar(v))
    if not interpolate:
        return cfg
    return Config(_interpolate(cfg, cfg))


def sweep_configs(path: str, overrides: List[str] | None = None) -> List[Config]:
    """Expand the multirun cross product.

    Sweep axes come from the config's ``sweeper.params`` block (also
    accepted under ``hydra.sweeper.params``), overridden/extended by
    comma-separated CLI overrides: the reference protocol of sweeping
    instance x initial point x solver.
    """
    base = Config(_read(path))
    params: Dict[str, list] = {}
    sweeper = base.get_path("sweeper.params") or base.get_path("hydra.sweeper.params") or {}
    for k, v in dict(sweeper).items():
        if isinstance(v, str):
            params[k] = [_parse_scalar(x) for x in v.split(",")]
        else:
            params[k] = [v]  # a literal list value is a single choice
    scalar_overrides = []
    for ov in overrides or []:
        k, v = ov.split("=", 1)
        if "," in v and not v.strip().startswith("["):
            params[k] = [_parse_scalar(x) for x in v.split(",")]
        elif k in params:
            # A single-value override of a sweep axis PINS it (Hydra
            # semantics): without this the per-combo set_path would clobber
            # the override with every sweep value.
            params[k] = [_parse_scalar(v)]
        else:
            scalar_overrides.append(ov)

    if not params:
        return [load_config(path, scalar_overrides)]
    keys = sorted(params)
    configs = []
    for combo in itertools.product(*(params[k] for k in keys)):
        # Interpolation must happen AFTER the sweep values are applied, or
        # ${problem_initialpoint}-style paths freeze at their defaults and
        # every job writes to the same directory.
        cfg = load_config(path, scalar_overrides, interpolate=False)
        for k, v in zip(keys, combo):
            cfg.set_path(k, v)
        configs.append(Config(_interpolate(cfg, cfg)))
    return configs


def solver_options_from_cfg(cfg: Config, solver_name: str) -> dict:
    """common <- solver-specific merge (``base_simulator.py:51-67``)."""
    so = cfg.get_path("solver_option") or {}
    option = dict(so.get("common", {}))
    option.update(so.get(solver_name, {}))
    return option


def maybe_help(argv, doc):
    """Shared -h/--help handling for the hand-rolled experiment CLIs."""
    if any(a in ("-h", "--help") for a in argv):
        print(doc)
        raise SystemExit(0)


def take_device(argv, with_dtype: bool = False):
    """Pop the port's ``--device DEV`` flag (and, ``with_dtype``,
    ``--dtype float32|float64``) from ``argv`` (a list, edited in place) ->
    (dtype, device) through ``config.resolve``: float64, the reference
    protocol's, and CUDA device 0 by default, which raises without CUDA;
    ``--device cpu`` runs on the CPU."""
    import torch

    from riptrm_torch.config import resolve

    values = {"--device": None, "--dtype": "float64"}
    for flag in values if with_dtype else ("--device",):
        while flag in argv:
            i = argv.index(flag)
            if i + 1 >= len(argv):
                raise SystemExit(f"{flag} requires a value")
            values[flag] = argv[i + 1]
            del argv[i:i + 2]
    if values["--dtype"] not in ("float32", "float64"):
        raise SystemExit(f"--dtype {values['--dtype']!r}: float32 or float64")
    return resolve(getattr(torch, values["--dtype"]), values["--device"])
