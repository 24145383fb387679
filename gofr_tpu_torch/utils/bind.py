"""Structure binding: parsed payloads → dataclasses / annotated classes (the
port's own copy of gofr_tpu/utils/bind.py).

The Python analog of the reference's reflection binding (gofr
`pkg/gofr/http/request.go:57-74` JSON bind, `pkg/gofr/cmd/request.go:90-117`
flag bind): a payload dict is bound into a user-declared shape with light type
coercion, so handlers declare plain dataclasses instead of parsing dicts.
"""

from __future__ import annotations

import dataclasses
import types
import typing
from typing import Any


class BindError(Exception):
    status_code = 400


def unwrap_optional(annotation: Any) -> Any:
    """``X | None`` / ``Optional[X]`` → ``X``; anything else unchanged.
    Shared by the JSON and multipart binders so union handling can't drift."""
    if typing.get_origin(annotation) in (typing.Union, types.UnionType):
        args = [a for a in typing.get_args(annotation) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return annotation


def bind_value(value: Any, annotation: Any) -> Any:
    """Coerce ``value`` to ``annotation`` (best effort, raises BindError)."""
    if annotation in (None, Any, typing.Any):
        return value
    origin = typing.get_origin(annotation)
    if origin is typing.Union or origin is types.UnionType:
        args = [a for a in typing.get_args(annotation) if a is not type(None)]
        if value is None:
            return None
        for arg in args:
            try:
                return bind_value(value, arg)
            except (BindError, TypeError, ValueError):
                continue
        raise BindError(f"cannot bind {value!r} to {annotation}")
    if origin in (list, tuple, set):
        (item_t,) = typing.get_args(annotation) or (Any,)
        if not isinstance(value, (list, tuple, set)):
            value = [value]
        seq = [bind_value(v, item_t) for v in value]
        return origin(seq)
    if origin is dict:
        return dict(value)
    if dataclasses.is_dataclass(annotation) and isinstance(annotation, type):
        return bind_dataclass(value, annotation)
    if annotation is bool:
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on")
        return bool(value)
    if annotation in (int, float, str):
        try:
            return annotation(value)
        except (TypeError, ValueError) as e:
            raise BindError(f"cannot bind {value!r} to {annotation.__name__}") from e
    if annotation is bytes:
        if isinstance(value, bytes):
            return value
        return str(value).encode()
    if isinstance(annotation, type) and isinstance(value, annotation):
        return value
    return value


def bind_dataclass(data: Any, cls: type) -> Any:
    if isinstance(data, cls):
        return data
    if not isinstance(data, dict):
        raise BindError(f"expected object for {cls.__name__}, got {type(data).__name__}")
    kwargs: dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        if f.name in data:
            kwargs[f.name] = bind_value(data[f.name], f.type if not isinstance(f.type, str) else _resolve(cls, f.name))
        elif f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING:  # type: ignore[misc]
            raise BindError(f"missing required field {f.name!r}")
    return cls(**kwargs)


def _resolve(cls: type, field_name: str) -> Any:
    try:
        hints = typing.get_type_hints(cls)
        return hints.get(field_name, Any)
    except Exception:  # noqa: BLE001
        return Any


def bind(data: Any, target: Any) -> Any:
    """Bind parsed data into ``target``.

    - dataclass type → constructed instance
    - ``dict``/``list``/scalars types → coerced value
    - annotated plain class → instance with attributes set
    """
    if target is dict:
        if not isinstance(data, dict):
            raise BindError("expected JSON object")
        return data
    if dataclasses.is_dataclass(target) and isinstance(target, type):
        return bind_dataclass(data, target)
    if isinstance(target, type) and hasattr(target, "__annotations__") and target.__annotations__:
        if not isinstance(data, dict):
            raise BindError(f"expected object for {target.__name__}")
        hints = typing.get_type_hints(target)
        obj = target()
        for name, ann in hints.items():
            if name in data:
                setattr(obj, name, bind_value(data[name], ann))
        return obj
    if isinstance(target, type):
        return bind_value(data, target)
    raise BindError(f"cannot bind into {target!r}")
