"""A small validating model base, the port's stand-in for pydantic.

The serving seam parses request bodies and passes results between
nodeflow runners through typed models.  This module covers what those
models use, and nothing more:

  * declared fields with defaults and ``default_factory`` (mutable
    defaults are copied per instance);
  * ``str``, ``int``, ``float``, ``bool``, ``dict``, ``Any``,
    ``Optional[...]``, ``Literal[...]``, ``list[...]`` and nested models
    (or lists of them), built from dicts;
  * ``Field(ge=, le=, min_length=, max_length=)`` and ``field_validator``
    (run after the type and constraints, as pydantic's "after" mode);
  * unknown keys ignored; ``model_fields``, ``model_dump(exclude_none=)``
    and ``ValidationError.errors()`` with ``loc``, ``msg`` and ``type``;
  * ``model_json_schema()``, the JSON schema pydantic v2 gives the same
    class (titles, defaults, ``anyOf`` for ``Optional``, ``items``,
    ``$defs`` / ``$ref`` for nested models, constraints, ``required``).

Coercion follows pydantic v2's lax mode for these types, and the error
messages are pydantic's own words, because ``parse_body`` puts the first
one into a 422 body: ``"5"`` and ``5.0`` are the int 5, ``5.5`` is not an
int, an int is not a ``str``, and ``bool`` takes 0 / 1 and the usual
strings.  Every error of a model is collected, in field declaration
order, as pydantic reports them.
"""

from __future__ import annotations

import copy
import inspect
import math
import typing
from typing import Any, Callable, Literal, Optional, Union

_MISSING = object()

_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


class ValidationError(ValueError):
    """Raised by a model's constructor; ``errors()`` lists every failure
    as ``{"type", "loc", "msg", "input"}``, as pydantic's does."""

    def __init__(self, title: str, errors: list[dict]):
        self.title = title
        self._errors = errors
        lines = [f"{len(errors)} validation error{'s' if len(errors) != 1 else ''} "
                 f"for {title}"]
        for e in errors:
            lines.append(".".join(str(x) for x in e["loc"]))
            lines.append(f"  {e['msg']} [type={e['type']}]")
        super().__init__("\n".join(lines))

    def errors(self) -> list[dict]:
        return [dict(e) for e in self._errors]


class _Invalid(Exception):
    def __init__(self, errors: list[dict]):
        self.errors = errors


def _fail(kind: str, msg: str, value: Any) -> _Invalid:
    return _Invalid([{"type": kind, "loc": (), "msg": msg, "input": value}])


class FieldInfo:
    def __init__(self, default: Any = _MISSING, default_factory: Optional[Callable] = None,
                 ge: Any = None, le: Any = None, min_length: Optional[int] = None,
                 max_length: Optional[int] = None):
        self.default = default
        self.default_factory = default_factory
        self.ge, self.le = ge, le
        self.min_length, self.max_length = min_length, max_length
        self.annotation: Any = None

    def is_required(self) -> bool:
        return self.default is _MISSING and self.default_factory is None

    def make_default(self) -> Any:
        if self.default_factory is not None:
            return self.default_factory()
        if isinstance(self.default, (list, dict, set)):
            return copy.deepcopy(self.default)
        return self.default


def Field(default: Any = _MISSING, *, default_factory: Optional[Callable] = None,  # noqa: N802
          ge: Any = None, le: Any = None, min_length: Optional[int] = None,
          max_length: Optional[int] = None) -> Any:
    return FieldInfo(default, default_factory, ge, le, min_length, max_length)


def field_validator(*names: str):
    """Run the decorated function on the named fields' validated values;
    a ``ValueError`` it raises becomes the field's "Value error, ..."."""
    def deco(fn):
        target = fn.__func__ if isinstance(fn, (classmethod, staticmethod)) else fn
        target.__validates__ = names
        return fn
    return deco


# -- scalar validators (pydantic v2 lax mode) -----------------------------------

def _v_str(v: Any) -> str:
    if isinstance(v, str):
        return v
    if isinstance(v, (bytes, bytearray)):
        return bytes(v).decode()
    raise _fail("string_type", "Input should be a valid string", v)


def _v_int(v: Any) -> int:
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v
    if isinstance(v, float):
        if not math.isfinite(v):
            raise _fail("finite_number", "Input should be a finite number", v)
        if v != int(v):
            raise _fail("int_from_float", "Input should be a valid integer, got a "
                        "number with a fractional part", v)
        if abs(v) > 2 ** 63:
            raise _fail("int_parsing_size", "Unable to parse input string as an "
                        "integer, exceeded maximum size", v)
        return int(v)
    if isinstance(v, (str, bytes)):
        s = v.decode() if isinstance(v, bytes) else v
        s = s.strip()
        head, dot, frac = s.partition(".")
        try:
            if dot and frac and frac.strip("0") == "" and head:
                return int(head)
            return int(s)
        except ValueError:
            raise _fail("int_parsing", "Input should be a valid integer, unable to "
                        "parse string as an integer", v) from None
    raise _fail("int_type", "Input should be a valid integer", v)


def _v_float(v: Any) -> float:
    if isinstance(v, (bool, int, float)):
        return float(v)
    if isinstance(v, (str, bytes)):
        try:
            return float(v)
        except ValueError:
            raise _fail("float_parsing", "Input should be a valid number, unable to "
                        "parse string as a number", v) from None
    raise _fail("float_type", "Input should be a valid number", v)


def _v_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        if v == 0 or v == 1:
            return bool(v)
        if isinstance(v, int):
            raise _fail("bool_parsing", "Input should be a valid boolean, unable to "
                        "interpret input", v)
        raise _fail("bool_type", "Input should be a valid boolean", v)
    if isinstance(v, (str, bytes)):
        s = (v.decode() if isinstance(v, bytes) else v).lower()
        if s in _TRUE:
            return True
        if s in _FALSE:
            return False
        raise _fail("bool_parsing", "Input should be a valid boolean, unable to "
                    "interpret input", v)
    raise _fail("bool_type", "Input should be a valid boolean", v)


def _v_dict(v: Any) -> dict:
    if isinstance(v, dict):
        return dict(v)
    raise _fail("dict_type", "Input should be a valid dictionary", v)


def _v_any(v: Any) -> Any:
    return v


_SCALARS = {str: _v_str, int: _v_int, float: _v_float, bool: _v_bool,
            dict: _v_dict, Any: _v_any, object: _v_any}


def _literal_text(values: tuple) -> str:
    reprs = [repr(x) for x in values]
    if len(reprs) == 1:
        return reprs[0]
    return ", ".join(reprs[:-1]) + " or " + reprs[-1]


def _number_text(x: Any) -> str:
    if isinstance(x, float) and x.is_integer():
        return str(int(x))
    return str(x)


def _validator(tp: Any) -> Callable[[Any], Any]:
    """A function value -> validated value for the annotation ``tp``;
    it raises ``_Invalid`` with locations relative to the value."""
    if tp in _SCALARS:
        return _SCALARS[tp]
    if tp is list:
        tp = list[Any]
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if origin is Union:
        inner = [a for a in args if a is not type(None)]
        if len(inner) != 1:
            raise TypeError(f"unsupported union {tp!r}")
        sub = _validator(inner[0])
        return lambda v: None if v is None else sub(v)
    if origin is Literal:
        text = _literal_text(args)

        def lit(v):
            for a in args:
                if type(v) is type(a) and v == a:
                    return a
            raise _fail("literal_error", f"Input should be {text}", v)
        return lit
    if origin is list:
        item = _validator(args[0] if args else Any)

        def lst(v):
            if not isinstance(v, (list, tuple, set, frozenset)):
                raise _fail("list_type", "Input should be a valid list", v)
            out, errors = [], []
            for i, x in enumerate(v):
                try:
                    out.append(item(x))
                except _Invalid as e:
                    errors.extend({**err, "loc": (i, *err["loc"])} for err in e.errors)
            if errors:
                raise _Invalid(errors)
            return out
        return lst
    if origin is dict:
        return _v_dict
    if isinstance(tp, type) and issubclass(tp, Model):
        return tp._coerce
    raise TypeError(f"unsupported annotation {tp!r}")


def _check_constraints(info: FieldInfo, v: Any) -> None:
    if v is None:
        return
    if info.ge is not None and v < info.ge:
        raise _fail("greater_than_equal", "Input should be greater than or equal "
                    f"to {_number_text(info.ge)}", v)
    if info.le is not None and v > info.le:
        raise _fail("less_than_equal", "Input should be less than or equal to "
                    f"{_number_text(info.le)}", v)
    if info.min_length is not None and len(v) < info.min_length:
        if isinstance(v, str):
            n = info.min_length
            raise _fail("string_too_short", f"String should have at least {n} "
                        f"character{'s' if n != 1 else ''}", v)
        raise _fail("too_short", f"List should have at least {info.min_length} "
                    f"item{'s' if info.min_length != 1 else ''} after validation, "
                    f"not {len(v)}", v)
    if info.max_length is not None and len(v) > info.max_length:
        if isinstance(v, str):
            n = info.max_length
            raise _fail("string_too_long", f"String should have at most {n} "
                        f"character{'s' if n != 1 else ''}", v)
        raise _fail("too_long", f"List should have at most {info.max_length} "
                    f"item{'s' if info.max_length != 1 else ''} after validation, "
                    f"not {len(v)}", v)


class Model:
    """Base of the port's validated models (see the module docstring)."""

    model_fields: dict[str, FieldInfo] = {}
    _checks: dict[str, Callable[[Any], Any]] = {}
    _validators: dict[str, list[Callable]] = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        hints = typing.get_type_hints(cls)
        fields: dict[str, FieldInfo] = {}
        for name, tp in hints.items():
            if name.startswith("_") or typing.get_origin(tp) is typing.ClassVar:
                continue
            if name == "model_fields":
                continue
            val = getattr(cls, name, _MISSING)
            info = val if isinstance(val, FieldInfo) else FieldInfo(default=val)
            info.annotation = tp
            fields[name] = info
        validators: dict[str, list[Callable]] = {}
        for klass in reversed(cls.__mro__):
            for attr in vars(klass).values():
                fn = attr.__func__ if isinstance(attr, (classmethod, staticmethod)) else attr
                for name in getattr(fn, "__validates__", ()):
                    validators.setdefault(name, []).append(
                        (lambda f: lambda v: f(cls, v))(fn)
                        if isinstance(attr, classmethod) else fn)
        cls.model_fields = fields
        cls._checks = {name: _validator(info.annotation) for name, info in fields.items()}
        cls._validators = validators

    def __init__(self, **data: Any):
        errors: list[dict] = []
        for name, info in self.model_fields.items():
            if name not in data:
                if info.is_required():
                    errors.append({"type": "missing", "loc": (name,),
                                   "msg": "Field required", "input": data})
                    continue
                object.__setattr__(self, name, info.make_default())
                continue
            raw = data[name]
            try:
                v = self._checks[name](raw)
                _check_constraints(info, v)
                for fn in self._validators.get(name, ()):
                    try:
                        v = fn(v)
                    except (ValueError, AssertionError) as e:
                        raise _fail("value_error", f"Value error, {e}", raw) from None
            except _Invalid as e:
                errors.extend({**err, "loc": (name, *err["loc"])} for err in e.errors)
                continue
            object.__setattr__(self, name, v)
        if errors:
            raise ValidationError(type(self).__name__, errors)

    @classmethod
    def _coerce(cls, v: Any) -> "Model":
        """A nested field's value: an instance is kept, a dict is built."""
        if isinstance(v, cls):
            return v
        if isinstance(v, dict):
            try:
                return cls(**v)
            except ValidationError as e:
                raise _Invalid(e.errors()) from None
        raise _fail("model_type", "Input should be a valid dictionary or instance "
                    f"of {cls.__name__}", v)

    @classmethod
    def model_json_schema(cls) -> dict:
        """The JSON schema of the class, as pydantic v2's
        ``model_json_schema()`` gives it; nested models go to ``$defs``."""
        defs: dict = {}
        out = _model_schema(cls, defs)
        if defs:
            out = {"$defs": dict(sorted(defs.items())), **out}
        return out

    def model_dump(self, exclude_none: bool = False) -> dict:
        out = {}
        for name in self.model_fields:
            v = _dump(getattr(self, name), exclude_none)
            if exclude_none and v is None:
                continue
            out[name] = v
        return out

    def __eq__(self, other: Any) -> bool:
        return type(other) is type(self) and self.model_dump() == other.model_dump()

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={getattr(self, k)!r}" for k in self.model_fields)
        return f"{type(self).__name__}({body})"


# -- JSON schema (pydantic v2's GenerateJsonSchema for these annotations) ------

def _type_schema(tp: Any, defs: dict) -> dict:
    if tp is str:
        return {"type": "string"}
    if tp is int:
        return {"type": "integer"}
    if tp is float:
        return {"type": "number"}
    if tp is bool:
        return {"type": "boolean"}
    if tp is dict:
        return {"additionalProperties": True, "type": "object"}
    if tp is Any or tp is object:
        return {}
    if tp is list:
        return {"items": {}, "type": "array"}
    origin, args = typing.get_origin(tp), typing.get_args(tp)
    if origin is Union:
        inner = [a for a in args if a is not type(None)]
        return {"anyOf": [_type_schema(inner[0], defs), {"type": "null"}]}
    if origin is Literal:
        kinds = {type(a) for a in args}
        out: dict = {"const": args[0]} if len(args) == 1 else {"enum": list(args)}
        if len(kinds) == 1:
            out["type"] = {str: "string", int: "integer", bool: "boolean",
                           float: "number"}[kinds.pop()]
        return out
    if origin is list:
        return {"items": _type_schema(args[0], defs) if args else {}, "type": "array"}
    if origin is dict:
        value = _type_schema(args[1], defs) if len(args) == 2 else {}
        return {"additionalProperties": value or True, "type": "object"}
    if isinstance(tp, type) and issubclass(tp, Model):
        if tp.__name__ not in defs:
            defs[tp.__name__] = {}  # a placeholder while the model recurses
            defs[tp.__name__] = _model_schema(tp, defs)
        return {"$ref": f"#/$defs/{tp.__name__}"}
    raise TypeError(f"unsupported annotation {tp!r}")


def _constrain(schema: dict, info: FieldInfo) -> None:
    """Field constraints, on the non-null branch of an ``Optional``."""
    target = schema["anyOf"][0] if "anyOf" in schema else schema
    array = target.get("type") == "array"
    for key, value in (("minimum", info.ge), ("maximum", info.le),
                       ("minItems" if array else "minLength", info.min_length),
                       ("maxItems" if array else "maxLength", info.max_length)):
        if value is not None:
            target[key] = value


def _sorted(schema: Any) -> Any:
    """Keys in alphabetical order, as pydantic writes them (a model's
    ``properties`` keep their declaration order)."""
    if isinstance(schema, dict):
        return {k: (dict((n, _sorted(v)) for n, v in schema[k].items())
                    if k == "properties" else _sorted(schema[k]))
                for k in sorted(schema)}
    if isinstance(schema, list):
        return [_sorted(x) for x in schema]
    return schema


def _model_schema(cls: type, defs: dict) -> dict:
    props, required = {}, []
    for name, info in cls.model_fields.items():
        schema = _type_schema(info.annotation, defs)
        _constrain(schema, info)
        inner = schema["anyOf"][0] if "anyOf" in schema else schema
        if "$ref" not in inner:
            schema["title"] = name.title().replace("_", " ")
        if info.is_required():
            required.append(name)
        elif info.default_factory is None:
            schema["default"] = _dump(info.default, False)
        props[name] = _sorted(schema)
    out: dict = {}
    doc = cls.__dict__.get("__doc__")
    if doc:
        out["description"] = inspect.cleandoc(doc)
    out["properties"] = props
    if required:
        out["required"] = required
    out["title"] = cls.__name__
    out["type"] = "object"
    return out


def _dump(v: Any, exclude_none: bool) -> Any:
    if isinstance(v, Model):
        return v.model_dump(exclude_none=exclude_none)
    if isinstance(v, (list, tuple)):
        return [_dump(x, exclude_none) for x in v]
    if isinstance(v, dict):
        return {k: _dump(x, exclude_none) for k, x in v.items()
                if not (exclude_none and x is None)}
    return v
