"""Nested attribute-accessible configuration objects.

Behavioral counterpart of the reference's ``buffalo/misc/_aux.py:16-89``
(``Option`` / ``InputOptions``): a dict subclass with recursive attribute
access, JSON-file/JSON-string constructors, pickling support and
type-validation of user options against a class's defaults.  A copy of
``buffalo_tpu.utils.option`` for the PyTorch port, which imports nothing
of the JAX package; the two pickle under their own module names and
``models.base`` maps the reference's name onto this one on load.
"""
from __future__ import annotations

import json
import os
from typing import Any


class Option(dict):
    """A dict whose string keys are also attributes, recursively.

    >>> o = Option({"a": {"b": 3}})
    >>> o.a.b
    3

    Accepts a dict, another Option, a path to a JSON file, or a JSON
    string.  Nested dicts are converted to Option eagerly so identity is
    stable and mutation through either access style is shared.
    """

    def __init__(self, *args: Any, **kwargs: Any):
        if len(args) == 1 and isinstance(args[0], str):
            src = args[0]
            if os.path.isfile(src):
                with open(src) as fin:
                    data = json.load(fin)
            else:
                data = json.loads(src)
            super().__init__(data)
        else:
            super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if isinstance(v, dict) and not isinstance(v, Option):
                self[k] = Option(v)

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        if isinstance(value, dict) and not isinstance(value, Option):
            value = Option(value)
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setitem__(self, key: Any, value: Any) -> None:
        if isinstance(value, dict) and not isinstance(value, Option):
            value = Option(value)
        super().__setitem__(key, value)

    # dict's (de)serialization already round-trips through pickle since we
    # store everything in the mapping itself; reduce to plain-dict payload
    # so that unpickling re-wraps nested dicts.
    def __reduce__(self):
        return (Option, (self.to_dict(),))

    def to_dict(self) -> dict:
        def conv(v: Any) -> Any:
            if isinstance(v, dict):
                return {k: conv(u) for k, u in v.items()}
            return v

        return {k: conv(v) for k, v in self.items()}

    def to_json(self, **kwargs: Any) -> str:
        return json.dumps(self.to_dict(), **kwargs)


class InputOptions:
    """Base for option factories: defaults + validation.

    Mirrors the contract of the reference ``InputOptions``
    (``_aux.py:63-89``): ``get_default_option`` returns the full default
    tree and ``is_valid_option`` type-checks a user-supplied option dict
    against those defaults (missing keys are errors; type mismatches are
    errors, except int-where-float-expected which is coerced to float).
    """

    def __init__(self, *args, **kwargs):
        pass

    def get_default_option(self) -> Option:
        return Option({})

    def is_valid_option(self, opt: dict) -> bool:
        # the reference iterates the DEFAULT keys (misc/_aux.py:71-80):
        # every default key must be present (a partial or typo'd dict
        # fails loudly here instead of via a late AttributeError deep
        # in train()); extra user keys are tolerated, as there
        default_opt = self.get_default_option()
        for key in default_opt:
            if key not in opt:
                raise RuntimeError(f"{key} not exists on Option")
            expected = default_opt[key]
            got = opt[key]
            if isinstance(expected, bool) or isinstance(got, bool):
                # bool is an int subclass; require exact boolness both ways
                if isinstance(expected, bool) != isinstance(got, bool):
                    raise RuntimeError(
                        f'Invalid type for option "{key}": expected '
                        f"{type(expected).__name__}, got {type(got).__name__}"
                    )
            elif isinstance(expected, float) and isinstance(got, int):
                opt[key] = float(got)
            elif expected is not None and got is not None and not isinstance(got, type(expected)):
                raise RuntimeError(
                    f'Invalid type for option "{key}": expected '
                    f"{type(expected).__name__}, got {type(got).__name__}"
                )
        return True
