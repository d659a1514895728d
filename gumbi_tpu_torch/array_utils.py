"""Type-checked stacking of structured arrays + lengthscale-bound helpers.

A copy of ``gumbi_tpu/array_utils.py`` (same names and bodies).
"""

import numpy as np

from .arrays import ParameterArray as parray
from .arrays import UncertainParameterArray as uparray
from .utils import assert_in, first, one

__all__ = ["make_deltas_parray", "stack", "vstack", "hstack"]


def make_deltas_parray(*, stdzr, scale, **deltas):
    """Build a parray of standardized per-dimension differences.

    Primarily used to express lengthscale bounds for the GP in whichever space
    ('natural', 'transformed', 'standardized') is convenient, converted to
    standardized deltas. A ``None`` entry yields NaN (meaning "use default").
    """
    assert_in("scale", scale, ["transformed", "standardized", "natural"])
    if scale == "transformed":
        deltas = {
            dim: [stdzr.untransform(dim, [v, v * 2]) if v is not None else None for v in vs]
            for dim, vs in deltas.items()
        }
    elif scale == "standardized":
        deltas = {
            dim: [stdzr.unstdz(dim, [v, v * 2]) if v is not None else None for v in vs]
            for dim, vs in deltas.items()
        }
    else:  # natural
        deltas = {
            dim: [[v, v * 2] if v is not None else None for v in vs] for dim, vs in deltas.items()
        }

    deltas = {
        dim: [np.diff(stdzr.stdz(dim, v)) if v is not None else [np.nan] for v in vs]
        for dim, vs in deltas.items()
    }
    return parray(**deltas, stdzr=stdzr, stdzd=True)


def _shared_stdzr(array_list):
    stdzr = first(array_list).stdzr
    if not all(a.stdzr is stdzr for a in array_list):
        raise ValueError("Arrays do not have the same standardizer.")
    return stdzr


def _check_same_names(array_list):
    all_names = [tuple(pa.names) for pa in array_list]
    if len(set(all_names)) != 1:
        raise ValueError("Arrays do not have the same names.")


def _combine(np_op, array_list, **kwargs):
    """Shared dispatch for stack/vstack/hstack over parray or uparray lists."""
    types = {type(a) for a in array_list}
    if len(types) != 1:
        raise ValueError("Arrays are not all of the same type.")
    cls = one(types)
    if cls is parray:
        _check_same_names(array_list)
    elif cls is uparray:
        if len({upa.name for upa in array_list}) != 1:
            raise ValueError("Arrays do not have the same name.")
    else:
        raise ValueError(f"Unknown array type: {cls}")
    new = np_op(array_list, **kwargs)
    stdzr = _shared_stdzr(array_list)
    fields = {dim: new[dim] for dim in new.dtype.names}
    if cls is uparray:
        return cls(first(array_list).name, **fields, stdzr=stdzr)
    return cls(**fields, stdzr=stdzr)


def stack(array_list, axis=0, **kwargs):
    """np.stack over parrays/uparrays (1-D inputs fall back to hstack)."""
    if {pa.ndim for pa in array_list} == {1}:
        return hstack(array_list)
    return _combine(lambda lst, **kw: np.stack(lst, axis=axis, **kw), array_list, **kwargs)


def vstack(array_list, **kwargs):
    """np.vstack over parrays/uparrays."""
    return _combine(np.vstack, array_list, **kwargs)


def hstack(array_list, **kwargs):
    """np.hstack over parrays/uparrays."""
    return _combine(np.hstack, array_list, **kwargs)
