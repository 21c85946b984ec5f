"""Typed, layered configuration system (a copy of the reference package's
``utils/configuration.py``).

Functional parity with the reference's ``ConfigWizard``
(reference: RetrievalAugmentedGeneration/common/configuration_wizard.py:99-297):

- a tree of frozen dataclasses describes the schema;
- values load from a YAML or JSON file (``from_file``);
- environment variables ``{PREFIX}_{SECTION}_{FIELD}`` overlay file values
  (reference: configuration_wizard.py:224-256 merges ``APP_*`` envvars);
- ``print_help`` emits self-documenting help for every field
  (reference: configuration_wizard.py:104-177).

The implementation is new: a single ``config_class`` decorator +
``ConfigField`` metadata instead of the reference's custom wizard metaclass.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from dataclasses import field, fields, is_dataclass
from typing import Any, IO, Mapping, Type, TypeVar, get_args, get_origin

from .errors import ConfigError

_T = TypeVar("_T")

ENV_PREFIX = "APP"  # reference uses APP_* (configuration_wizard.py:179-222)


def configfield(name: str, *, default: Any = dataclasses.MISSING,
                default_factory: Any = dataclasses.MISSING,
                env: bool = True, help_txt: str = "") -> Any:
    """Declare a config field with env-name + help metadata.

    Parity with ``configfield`` (reference: configuration_wizard.py:49-96).
    """
    meta = {"cfg_name": name, "env": env, "help": help_txt}
    if default_factory is not dataclasses.MISSING:
        return field(default_factory=default_factory, metadata=meta)
    if default is dataclasses.MISSING:
        return field(metadata=meta)
    return field(default=default, metadata=meta)


def _coerce(value: Any, typ: Any) -> Any:
    """Coerce a parsed YAML/JSON/env value to the annotated field type."""
    if typ is Any:
        return value
    if typ in (list, tuple):  # bare container annotation: split strings, no item coercion
        if isinstance(value, str):
            value = [v.strip() for v in value.split(",") if v.strip()]
        return typ(value)
    origin = get_origin(typ)
    if origin is not None:
        if origin in (list, tuple):
            (item_t,) = get_args(typ)[:1] or (Any,)
            if isinstance(value, str):
                value = [v.strip() for v in value.split(",") if v.strip()]
            return origin(_coerce(v, item_t) for v in value)
        if origin is dict:
            return dict(value)
        # Optional[T] and unions: try each arm.
        for arm in get_args(typ):
            if arm is type(None):
                if value is None:
                    return None
                continue
            try:
                return _coerce(value, arm)
            except (TypeError, ValueError):
                continue
        raise ConfigError(f"cannot coerce {value!r} to {typ}")
    if is_dataclass(typ):
        if isinstance(value, typ):
            return value
        if isinstance(value, Mapping):
            return from_dict(typ, value)
        raise ConfigError(f"expected mapping for {typ.__name__}, got {value!r}")
    if typ is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    if typ in (int, float, str):
        return typ(value)
    return value


def _env_var_name(prefix: str, path: tuple[str, ...]) -> str:
    # Field names collapse to one env token each: ``model_name`` →
    # ``MODELNAME`` so the section/field boundary stays unambiguous —
    # same convention as the reference's APP_LLM_MODELNAME etc.
    # (reference: configuration_wizard.py:179-222).
    return "_".join([prefix] + [p.upper().replace("-", "").replace("_", "")
                                for p in path])


def from_dict(cls: Type[_T], data: Mapping[str, Any], *,
              _env_path: tuple[str, ...] = (), _prefix: str = ENV_PREFIX) -> _T:
    """Build a config dataclass from a mapping, overlaying env vars.

    Env overlay mirrors the reference's merge of ``APP_{SECTION}_{FIELD}``
    on top of file values (reference: configuration_wizard.py:241-253):
    env wins over file, file wins over schema default.
    """
    if not is_dataclass(cls):
        raise ConfigError(f"{cls!r} is not a config dataclass")
    hints = _type_hints(cls)
    kwargs: dict[str, Any] = {}
    for f in fields(cls):
        cfg_name = f.metadata.get("cfg_name", f.name)
        path = _env_path + (cfg_name,)
        present = cfg_name in data or f.name in data
        raw = data.get(cfg_name, data.get(f.name, dataclasses.MISSING))
        typ = hints[f.name]

        if is_dataclass(_unwrap_optional(typ)):
            sub_cls = _unwrap_optional(typ)
            if present and raw is None:
                # An empty YAML section header ("llm:") parses to None;
                # treat it as "use defaults", not an error.
                present, raw = False, dataclasses.MISSING
            if present and not isinstance(raw, Mapping):
                raise ConfigError(
                    f"config section {'.'.join(path)} must be a mapping, "
                    f"got {type(raw).__name__}: {raw!r}")
            sub_data = raw if present else {}
            kwargs[f.name] = from_dict(sub_cls, sub_data, _env_path=path, _prefix=_prefix)
            continue

        env_name = _env_var_name(_prefix, path)
        if f.metadata.get("env", True) and env_name in os.environ:
            raw, present = os.environ[env_name], True
        if present and raw is None and _unwrap_optional(typ) is typ:
            # Explicit YAML null on a non-Optional field means "unset":
            # fall through to the schema default rather than str(None).
            present = False
        if not present:
            if f.default is not dataclasses.MISSING:
                kwargs[f.name] = f.default
                continue
            if f.default_factory is not dataclasses.MISSING:  # type: ignore[misc]
                kwargs[f.name] = f.default_factory()  # type: ignore[misc]
                continue
            raise ConfigError(f"missing required config field {'.'.join(path)}")
        try:
            kwargs[f.name] = _coerce(raw, typ)
        except ConfigError:
            raise
        except (TypeError, ValueError) as exc:
            raise ConfigError(
                f"invalid value for config field {'.'.join(path)}: "
                f"{raw!r} ({exc})") from exc
    return cls(**kwargs)  # type: ignore[return-value]


def _type_hints(cls: Type[Any]) -> dict[str, Any]:
    cached = _HINT_CACHE.get(cls)
    if cached is None:
        import typing
        cached = _HINT_CACHE[cls] = typing.get_type_hints(cls)
    return cached


_HINT_CACHE: dict[type, dict[str, Any]] = {}


def _resolve_type(cls: Type[Any], field_name: str) -> Any:
    return _type_hints(cls)[field_name]


def _unwrap_optional(typ: Any) -> Any:
    if get_origin(typ) is not None:
        args = [a for a in get_args(typ) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return typ


def from_file(cls: Type[_T], path: str | os.PathLike[str] | None, *,
              prefix: str = ENV_PREFIX) -> _T:
    """Load config from a YAML or JSON file + env overlay.

    ``path=None`` (or a missing file) loads pure defaults + env — the
    reference does the same when ``APP_CONFIG_FILE`` is unset
    (reference: common/utils.py:133-140, configuration_wizard.py:258-297).
    """
    data: dict[str, Any] = {}
    if path is not None and os.path.exists(os.fspath(path)):
        with open(path, "r", encoding="utf-8") as fh:
            data = _parse_config_stream(fh, os.fspath(path))
    return from_dict(cls, data, _prefix=prefix)


def _parse_config_stream(fh: IO[str], name: str) -> dict[str, Any]:
    text = fh.read()
    if name.endswith(".json"):
        return json.loads(text) or {}
    try:
        import yaml
        return yaml.safe_load(text) or {}
    except ImportError:  # pragma: no cover - yaml is baked into the image
        return json.loads(text) or {}


def asdict(cfg: Any) -> dict[str, Any]:
    """Config tree → plain dict keyed by ``cfg_name``."""
    out: dict[str, Any] = {}
    for f in fields(cfg):
        name = f.metadata.get("cfg_name", f.name)
        val = getattr(cfg, f.name)
        out[name] = asdict(val) if is_dataclass(val) else val
    return out


def print_help(cls: Type[Any], *, stream: IO[str] | None = None,
               _path: tuple[str, ...] = (), prefix: str = ENV_PREFIX) -> None:
    """Emit self-documenting help for every field.

    Parity with ``ConfigWizard.print_help``
    (reference: configuration_wizard.py:104-177).
    """
    stream = stream or sys.stdout
    for f in fields(cls):
        name = f.metadata.get("cfg_name", f.name)
        path = _path + (name,)
        typ = _unwrap_optional(_resolve_type(cls, f.name))
        if is_dataclass(typ):
            stream.write(f"\n[{'.'.join(path)}]\n")
            print_help(typ, stream=stream, _path=path, prefix=prefix)
            continue
        default = (f.default if f.default is not dataclasses.MISSING
                   else (f.default_factory() if f.default_factory is not dataclasses.MISSING  # type: ignore[misc]
                         else "<required>"))
        env = _env_var_name(prefix, path) if f.metadata.get("env", True) else "(no env)"
        help_txt = f.metadata.get("help", "")
        t_name = getattr(typ, "__name__", str(typ))
        stream.write(f"  {'.'.join(path)}  ({t_name})  default={default!r}  env={env}\n")
        if help_txt:
            stream.write(f"      {help_txt}\n")


def update_dict(base: dict[str, Any], overlay: Mapping[str, Any]) -> dict[str, Any]:
    """Recursive dict merge, overlay wins.

    Parity with ``update_dict`` (reference: configuration_wizard.py:375-399).
    """
    out = dict(base)
    for k, v in overlay.items():
        if isinstance(v, Mapping) and isinstance(out.get(k), dict):
            out[k] = update_dict(out[k], v)
        else:
            out[k] = v
    return out
