"""YAML config system, the twin of scp_tpu/config.py, without PyYAML.

The card's machine has no PyYAML, so this module reads and writes the
subset of YAML that `configs/**/*.yaml` and `save_config` use:

  * block mappings by indentation (`key: value`, `key:` + nested block);
  * block sequences (`- item`, `- group: file.yaml`: the `defaults:` list);
  * flow sequences `[4, 4, 2]` (nested allowed) and `{}`;
  * plain, 'single' and "double" quoted scalars, resolved as YAML 1.1
    (PyYAML's safe_load) resolves them: null/~, true/false/yes/no/on/off,
    decimal ints, floats with a dot (`1e-4` without a dot stays a string);
  * `#` comments.

Everything else (anchors, multi-line scalars, block flow mappings) raises.
Around the reader the module is scp_tpu's: `Config`, the `defaults:`
composition, `${a.b}` interpolation, dotted overrides parsed with
ast.literal_eval, `save_config` / `load_run_config`.
"""

from __future__ import annotations

import ast
import copy
import math
import os
import re
from typing import Any


class Config(dict):
    """dict with attribute access and dotted-path get/set."""

    def __getattr__(self, k):
        try:
            v = self[k]
        except KeyError as e:
            raise AttributeError(k) from e
        return v

    def __setattr__(self, k, v):
        self[k] = v

    def get_path(self, path: str, default=None):
        cur: Any = self
        for part in path.split("."):
            if not isinstance(cur, dict) or part not in cur:
                return default
            cur = cur[part]
        return cur

    def set_path(self, path: str, value):
        parts = path.split(".")
        cur: Any = self
        for p in parts[:-1]:
            if p not in cur or not isinstance(cur[p], dict):
                cur[p] = Config()
            cur = cur[p]
        cur[parts[-1]] = value

    @staticmethod
    def wrap(obj):
        if isinstance(obj, dict):
            return Config({k: Config.wrap(v) for k, v in obj.items()})
        if isinstance(obj, list):
            return [Config.wrap(v) for v in obj]
        return obj

    def to_plain(self):
        def unwrap(o):
            if isinstance(o, dict):
                return {k: unwrap(v) for k, v in o.items()}
            if isinstance(o, list):
                return [unwrap(v) for v in o]
            return o

        return unwrap(self)


# ---- the YAML subset ----------------------------------------------------

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(inf|Inf|INF)$")
_NAN = re.compile(r"\.(nan|NaN|NAN)$")


def _scalar(text: str):
    """A plain scalar resolved as YAML 1.1's implicit tags do."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and text not in (".", "-.", "+."):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return -math.inf if text.startswith("-") else math.inf
    if _NAN.match(text):
        return math.nan
    return text


def _strip_comment(line: str) -> str:
    """Drop a `#` comment that is not inside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _split_flow(body: str) -> list[str]:
    """Split a flow sequence's body on top-level commas."""
    items, depth, quote, cur = [], 0, None, ""
    for ch in body:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append(cur)
            cur = ""
            continue
        cur += ch
    if cur.strip():
        items.append(cur)
    return items


def _value(text: str):
    text = text.strip()
    if text.startswith("[") and text.endswith("]"):
        return [_value(t) for t in _split_flow(text[1:-1])]
    if text == "{}":
        return {}
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return ast.literal_eval(text)
    if text[:1] in "&*!|>{" and text:
        raise ValueError(f"YAML feature outside the supported subset: {text!r}")
    return _scalar(text)


def _split_key(text: str):
    """'key: value' -> (key, value text) or None when the line is no mapping
    entry (a colon must be followed by a space or end the line)."""
    m = re.match(r"""^(?P<key>'[^']*'|"[^"]*"|[^'"\s#][^:#]*?)\s*:(\s+|$)(?P<rest>.*)$""", text)
    if not m:
        return None
    key = m.group("key")
    if key[0] in "'\"":
        key = key[1:-1]
    return key, m.group("rest")


def _parse_block(lines, i: int, indent: int):
    """Parse the block starting at lines[i], whose lines sit at `indent`.
    Returns (value, next line index)."""
    if lines[i][1].startswith("- ") or lines[i][1] == "-":
        seq = []
        while i < len(lines) and lines[i][0] == indent and (
                lines[i][1].startswith("- ") or lines[i][1] == "-"):
            body = lines[i][1][1:].strip()
            entry = _split_key(body)
            if entry is not None:  # "- key: value": a one-entry mapping
                key, rest = entry
                if not rest.strip():
                    raise ValueError(f"nested mapping in a sequence item: {body!r}")
                seq.append({key: _value(rest)})
            else:
                seq.append(_value(body))
            i += 1
        return seq, i
    out: dict = {}
    while i < len(lines) and lines[i][0] == indent:
        entry = _split_key(lines[i][1])
        if entry is None:
            raise ValueError(f"expected `key: value`, got {lines[i][1]!r}")
        key, rest = entry
        i += 1
        if rest.strip():
            out[key] = _value(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and lines[i][1].startswith("-"))):
            out[key], i = _parse_block(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


def yaml_load(text: str):
    """The supported YAML subset -> Python (None for an empty document)."""
    lines = []
    for raw in text.splitlines():
        if raw.strip() in ("---", "..."):
            continue
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs in indentation")
        body = _strip_comment(raw).rstrip()
        if body.strip():
            lines.append((len(body) - len(body.lstrip(" ")), body.strip()))
    if not lines:
        return None
    value, i = _parse_block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected indentation at {lines[i][1]!r}")
    return value


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "." not in r:  # 1e-05 would read back as a string in YAML 1.1
            mant, _, exp = r.partition("e")
            r = f"{mant}.0" + (f"e{exp if exp[0] in '+-' else '+' + exp}" if exp else "")
        return r
    if isinstance(v, str):
        plain = (v == v.strip() and v and _scalar(v) == v and not any(
            c in v for c in ":#'\"[]{},&*!|>%@`") and v[0] not in "-?+.0123456789")
        return v if plain else "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot write {type(v).__name__} to the YAML subset")


def _dump_flow(v) -> str:
    if isinstance(v, list):
        return "[" + ", ".join(_dump_flow(x) for x in v) + "]"
    if isinstance(v, dict):
        if v:
            raise TypeError("a mapping inside a list is outside the YAML subset")
        return "{}"
    return _dump_scalar(v)


def yaml_dump(obj: dict, indent: int = 0) -> str:
    """A nested dict of scalars, dicts and lists -> YAML that yaml_load
    (and PyYAML) read back as the same value."""
    pad = " " * indent
    out = []
    for k, v in obj.items():
        key = _dump_scalar(str(k))
        if isinstance(v, dict) and v:
            out.append(f"{pad}{key}:\n" + yaml_dump(v, indent + 2))
        else:
            out.append(f"{pad}{key}: {_dump_flow(v)}\n")
    return "".join(out)


# ---- scp_tpu's config surface -------------------------------------------


def _deep_merge(base: dict, extra: dict) -> dict:
    out = copy.deepcopy(dict(base))
    for k, v in extra.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


_INTERP = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def _resolve_interp(cfg: Config):
    def resolve(value, root, depth=0):
        if depth > 20:
            raise ValueError("interpolation cycle")
        if isinstance(value, str):
            m = _INTERP.fullmatch(value.strip())
            if m:
                ref = root.get_path(m.group(1))
                if ref is None:
                    raise KeyError(f"interpolation target missing: {value}")
                return resolve(ref, root, depth + 1)
            return _INTERP.sub(
                lambda m2: str(resolve(root.get_path(m2.group(1)), root, depth + 1)),
                value,
            )
        if isinstance(value, dict):
            for k in list(value.keys()):
                value[k] = resolve(value[k], root, depth)
        if isinstance(value, list):
            return [resolve(v, root, depth) for v in value]
        return value

    resolve(cfg, cfg)
    return cfg


def _parse_value(text: str):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def _read(path: str):
    with open(path) as f:
        return yaml_load(f.read())


def _load_file(path: str, config_dir: str) -> dict:
    raw = _read(path) or {}
    defaults = raw.pop("defaults", [])
    merged: dict = {}
    for entry in defaults:
        if isinstance(entry, str):
            # plain entries resolve relative to the including file's dir
            merged = _deep_merge(
                merged, _load_file(os.path.join(os.path.dirname(path), entry), config_dir))
        elif isinstance(entry, dict):
            for group, name in entry.items():
                sub = _load_file(os.path.join(config_dir, group, name), config_dir)
                merged = _deep_merge(merged, {group: sub})
    return _deep_merge(merged, raw)


def load_config(config_name: str, config_dir: str = "configs",
                overrides: list[str] | None = None) -> Config:
    """Compose a config file with its defaults list and CLI overrides."""
    if not config_name.endswith((".yaml", ".yml")):
        config_name += ".yaml"
    merged = _load_file(os.path.join(config_dir, config_name), config_dir)
    cfg = Config.wrap(merged)
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override must be key=value: {ov}")
        key, val = ov.split("=", 1)
        cfg.set_path(key.strip(), Config.wrap(_parse_value(val.strip())))
    return _resolve_interp(cfg)


def save_config(cfg: Config, run_dir: str) -> str:
    """Archive the resolved config in the run dir (eval re-reads it)."""
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, "config.yaml")
    with open(path, "w") as f:
        f.write(yaml_dump(cfg.to_plain()))
    return path


def load_run_config(run_dir: str) -> Config:
    return _resolve_interp(Config.wrap(_read(os.path.join(run_dir, "config.yaml"))))
