"""Experiment-directory scaffolding and figure export helpers.

A copy of ``gumbi_tpu/utils/generic_utils.py`` (same names and bodies).
"""

from pathlib import Path

__all__ = ["setup_paths", "savefig"]

# Sibling directories expected next to the Code directory in the reference's
# experiment layout. Order matters: callers unpack positionally.
_SIBLINGS = ("Data", "Results", "Figures")


def setup_paths(make_missing=True):
    """Resolve the experiment directory layout around the working directory.

    The cwd is taken to be the experiment's ``Code`` directory; ``Data``,
    ``Results``, and ``Figures`` live beside it under the common parent.

    Returns the tuple ``(base, code, data, results, figures)`` of
    :class:`pathlib.Path` objects. With ``make_missing`` (the default) the
    three sibling directories are created if absent.
    """
    code = Path.cwd()
    siblings = tuple(code.parent / name for name in _SIBLINGS)
    if make_missing:
        for directory in siblings:
            directory.mkdir(parents=True, exist_ok=True)
    return (code.parent, code) + siblings


def savefig(filename: str, fig=None, path=None, silent=False, **kwargs):
    """Export a matplotlib figure as both ``.png`` (300 dpi) and ``.svg``.

    ``filename`` is extensionless; ``fig`` defaults to the current figure and
    ``path`` to the experiment's Figures directory (via :func:`setup_paths`).
    Keyword arguments pass through to ``Figure.savefig``; tight bounding box
    and transparency are applied unless overridden.
    """
    import matplotlib.pyplot as plt

    if fig is None:
        fig = plt.gcf()
    if path is None:
        path = setup_paths(make_missing=False)[-1]
    options = {"bbox_inches": "tight", "transparent": True, **kwargs}

    def _progress(msg, end=""):
        if not silent:
            print(msg, end=end)

    _progress("Saving.")
    fig.savefig(Path(path) / f"{filename}.png", dpi=300, **options)
    _progress(".")
    fig.savefig(Path(path) / f"{filename}.svg", **options)
    _progress("Done", end="\n")
