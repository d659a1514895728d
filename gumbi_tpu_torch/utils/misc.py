"""Small host-side helpers.

A copy of ``gumbi_tpu/utils/misc.py``: the same names and bodies, so the
model layer's parsing behaves as the reference's does.
"""

from functools import wraps
from itertools import chain, islice
from operator import attrgetter
from typing import Iterable, Iterator

import numpy as np

__all__ = [
    "NotExactlyOneError",
    "one",
    "first",
    "extract",
    "listify",
    "flatten",
    "group_by",
    "skip",
    "NotImplementedWrapper",
    "assert_in",
    "assert_is_subset",
    "assert_one",
    "list_is_are",
    "list_and",
    "round_to_n",
    "prettyprint_dict",
    "batched",
    "s",
    "Trigger",
    "InstanceCopy",
]


class NotExactlyOneError(Exception):
    """Raised when an iterable does not contain exactly one element."""


def listify(x) -> list:
    """Coerce input to a list (strings stay whole; None becomes [])."""
    if x is None:
        return []
    if isinstance(x, list):
        return x
    if isinstance(x, str):
        return [x]
    if isinstance(x, (set, Iterator, Iterable)):
        return list(x)
    return [x]


def one(itr: Iterable):
    """Return the single element of ``itr``, raising if there isn't exactly one."""
    lst = listify(itr)
    if len(lst) != 1:
        raise NotExactlyOneError(f"Expected one element in list, got {len(lst)}")
    return lst[0]


def first(itr: Iterable):
    """Return the first element of ``itr``."""
    return listify(itr)[0]


def extract(attr, itr):
    """Pull the named attribute off every element of ``itr``."""
    return [attrgetter(attr)(el) for el in itr]


def flatten(list_of_lists, depth=-1):
    """Flatten ``depth`` levels of nesting; ``depth=-1`` flattens fully."""
    if depth == 0:
        return list_of_lists
    if depth == -1:
        if not isinstance(first(list_of_lists), list):
            return list_of_lists
        depth = 0
    return flatten(list(chain.from_iterable(list_of_lists)), depth - 1)


def group_by(itr, key, unique=False):
    """Group elements of ``itr`` by ``key`` (callable or attribute name)."""
    if isinstance(key, str):
        key = attrgetter(key)
    pick = one if unique else skip
    return {grp: pick([el for el in itr if key(el) == grp]) for grp in set(map(key, itr))}


def skip(x):
    """Identity function (used as the no-op transform)."""
    return x


def NotImplementedWrapper(func):
    """Decorator that blocks a function, raising NotImplementedError on call."""

    @wraps(func)
    def block(*args, **kwargs):
        raise NotImplementedError

    return block


def assert_in(name: str, arg, itr: Iterable):
    """Raise ValueError unless ``arg`` is a member of ``itr``."""
    if arg not in itr:
        raise ValueError(f"{name} must be one of {itr}")


def assert_is_subset(name: str, subset: Iterable, superset: Iterable):
    """Raise ValueError if any element of ``subset`` is absent from ``superset``."""
    missing = list(set(subset) - set(superset))
    if missing:
        raise ValueError(f"{_is_are(missing)} missing from {name}")


def assert_one(names: str, itr: Iterable):
    """Raise ValueError unless exactly one element of ``itr`` is not None."""
    if sum(el is not None for el in itr) != 1:
        raise ValueError(f"Exactly one of {names} must be supplied")


def _list_and(lst: list) -> str:
    lst = listify(lst)
    if not lst:
        return ""
    if len(lst) == 1:
        return f"{lst[0]}"
    if len(lst) == 2:
        return f"{lst[0]} and {lst[1]}"
    return f'{", ".join(str(el) for el in lst[:-1])}, and {lst[-1]}'


def _is_are(lst: list) -> str:
    lst = listify(lst)
    if not lst:
        return None
    verb = "is" if len(lst) == 1 else "are"
    return f"{_list_and(lst)} {verb}"


# Public spellings matching the reference surface (ref utils/misc.py:116-137).
list_and = _list_and
list_is_are = _is_are


def s(n) -> str:
    """Pluralization suffix."""
    return "s" if n != 1 else ""


def round_to_n(x, n=2):
    """Round to ``n`` significant digits (scalar, list, or ndarray)."""

    def _round_one(v):
        if v == 0:
            return 0
        return np.round(v, -int(np.floor(np.log10(np.abs(v))) - (n - 1)))

    if isinstance(x, float):
        rounded = _round_one(x)
    elif isinstance(x, (list, np.ndarray)):
        rounded = [_round_one(v) for v in x]
    else:
        raise ValueError("x must be float, list, or ndarray.")
    return np.where(np.asarray(x) == 0.0, x, rounded)


def prettyprint_dict(dct, lpad=2):
    """Right-aligned key: value rendering of a dict."""
    width = max(map(len, dct.keys())) + lpad
    lines = []
    for k, v in dct.items():
        left = k.rjust(width)
        right = v if isinstance(v, str) else np.array2string(np.array(v), prefix=left + ": ")
        lines.append(f"{left}: {right}")
    return "\n".join(lines)


def batched(iterable, n):
    """Yield successive n-sized tuples from ``iterable``."""
    if n < 1:
        raise ValueError("n must be at least one")
    it = iter(iterable)
    while batch := tuple(islice(it, n)):
        yield batch


class Trigger:
    """Descriptor: property that invokes an instance method whenever set."""

    def __init__(self, method, default=None):
        self.default = default
        self.method = method
        self.data = {}

    def __get__(self, instance, owner):
        return self.data.get(instance, self.default)

    def __set__(self, instance, value):
        self.data[instance] = value
        getattr(instance, self.method)()


class InstanceCopy:
    """Instances are created by copying every attribute of a parent instance."""

    def __init__(self, parent):
        assert isinstance(parent, self.__class__.__bases__[-1])
        for attr in parent.__dict__:
            setattr(self, attr, getattr(parent, attr))
