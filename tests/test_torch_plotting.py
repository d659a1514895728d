"""The port's plotting layer against the reference's.

``gumbi_tpu_torch/plotting.py`` (``ParrayPlotter``), ``style/`` and
``versions.py`` are copies of ``gumbi_tpu``'s. These tests hold every class
and function source of the copies equal to the reference's, import lines
aside, the style files byte-equal, run ``tests/test_plots.py``'s cases on
the port's parrays and ``Standardizer`` (Agg backend), and import the
package with matplotlib blocked.
"""

import inspect
import os
import subprocess
import sys

import matplotlib.pyplot as plt
import numpy as np
import pytest

import gumbi_tpu.plotting
import gumbi_tpu.style
import gumbi_tpu.versions
import gumbi_tpu_torch as gmt
import gumbi_tpu_torch.plotting
import gumbi_tpu_torch.style
import gumbi_tpu_torch.versions
import test_plots
from test_torch_model_layer import _body, _defined_in

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_plotting_sources_equal_the_reference():
    ref, port = _defined_in(gumbi_tpu.plotting), _defined_in(gumbi_tpu_torch.plotting)
    assert "ParrayPlotter" in ref and sorted(ref) == sorted(port)
    for name, obj in ref.items():
        assert _body(obj) == _body(port[name]), f"plotting.{name} differs from the reference"
    assert gmt.ParrayPlotter is gumbi_tpu_torch.plotting.ParrayPlotter
    assert gumbi_tpu_torch.plotting.Standardizer is gmt.Standardizer


def test_style_and_version_equal_the_reference():
    for name in ("futura", "breve", "default"):
        ref, port = getattr(gumbi_tpu.style, name), getattr(gumbi_tpu_torch.style, name)
        assert ref.name == port.name and port.parent == gumbi_tpu_torch.style.style_dir
        assert port.read_bytes() == ref.read_bytes(), name
    assert gmt.__version__ == gumbi_tpu_torch.versions.__version__ == gumbi_tpu.versions.__version__
    with plt.style.context(gumbi_tpu_torch.style.default):
        pass


def _port_xyz():
    """test_plots.py's ``xyz`` fixture on the port's parray."""
    x, y = np.meshgrid(np.arange(1, 10, 0.25), np.arange(1, 10, 0.25))
    z = np.sin(np.sqrt((x - 5) ** 2 + (y - 5) ** 2)) ** 2 * 0.9 + 0.05
    return gmt.ParameterArray(x=x, y=y, z=z, stdzr=test_plots.stdzr)


PLOT_CASES = sorted(name for name in vars(test_plots) if name.startswith("test_"))


@pytest.mark.parametrize("name", PLOT_CASES)
def test_reference_plot_cases_on_port_parrays(name, monkeypatch):
    """Each of test_plots.py's cases, its module names pointing at the
    port's ``ParameterArray``, ``UncertainParameterArray``, ``ParrayPlotter``
    and a port ``Standardizer`` with the same moments."""
    stdzr = gmt.Standardizer(**{k: dict(v) for k, v in test_plots.stdzr.items()},
                             log_vars=test_plots.stdzr.log_vars, logit_vars=test_plots.stdzr.logit_vars)
    for attr, value in (("ParameterArray", gmt.ParameterArray), ("UncertainParameterArray", gmt.uparray),
                        ("ParrayPlotter", gmt.ParrayPlotter), ("Standardizer", gmt.Standardizer),
                        ("stdzr", stdzr)):
        monkeypatch.setattr(test_plots, attr, value)
    fn = getattr(test_plots, name)
    try:
        fn(*([_port_xyz()] if "xyz" in inspect.signature(fn).parameters else []))
    finally:
        plt.close("all")


def test_package_imports_without_matplotlib():
    code = """
import sys
sys.modules["matplotlib"] = None
sys.modules["seaborn"] = None
import gumbi_tpu_torch as gmt
assert gmt.ParrayPlotter.__name__ == "ParrayPlotter" and gmt.__version__
assert gmt.style.default.name == "presentation.mplstyle"
try:
    gmt.ParrayPlotter(gmt.parray(x=[1.0, 2.0], stdzr=gmt.Standardizer(x={"μ": 0, "σ2": 1})),
                      gmt.parray(y=[1.0, 2.0], stdzr=gmt.Standardizer(y={"μ": 0, "σ2": 1}))).plot()
except ImportError as e:
    assert "matplotlib" in str(e), e
else:
    raise AssertionError("plotted without matplotlib")
print("ok")
"""
    env = {**os.environ, "PYTHONPATH": REPO}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, env=env, cwd=REPO)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]
