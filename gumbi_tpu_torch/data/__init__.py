"""Bundled example datasets (imports pandas).

A copy of ``gumbi_tpu/data/__init__.py``: the same deterministic synthetic
tables, generated locally.

* :func:`cars` — an auto-mpg-style wide table (mpg, horsepower, weight,
  displacement, acceleration, origin, model_year).
* :func:`example_tidy` — a lab-style tidy table (several named entities
  observed on an (X, Y, lg10_Z) grid with six output parameters).
* ``example_dataset`` — path to a pickled copy of :func:`example_tidy`,
  written into this package's directory on first access.
"""

import pathlib as pl

import numpy as np
import pandas as pd

data_dir = pl.Path(__file__).resolve().parent

__all__ = ["cars", "example_tidy", "example_dataset", "load_dataset", "data_dir"]

_ORIGINS = ["usa", "japan", "europe"]


def cars(n=392, seed=2021) -> pd.DataFrame:
    """Deterministic auto-mpg-style dataset.

    All float columns are strictly positive; mpg falls smoothly with
    horsepower and weight (plus noise), so ``log_vars=['mpg', 'horsepower',
    'weight', 'displacement', 'acceleration']`` behaves like the classic
    seaborn `mpg` quickstart.
    """
    rng = np.random.default_rng(seed)
    origin = rng.choice(_ORIGINS, size=n, p=[0.62, 0.20, 0.18])
    origin_hp_shift = np.select(
        [origin == "usa", origin == "japan"], [0.25, -0.15], default=-0.05
    )

    log_hp = rng.normal(4.55 + origin_hp_shift, 0.35, size=n)
    horsepower = np.exp(log_hp).clip(45, 240)

    weight = np.exp(6.55 + 0.55 * (np.log(horsepower) - 4.6) + rng.normal(0, 0.12, n))
    displacement = np.exp(4.9 + 1.1 * (np.log(horsepower) - 4.6) + rng.normal(0, 0.18, n))
    cylinders = np.clip(np.round(displacement / 55 + 2.5), 3, 8).astype(int)

    log_mpg = (
        3.20
        - 0.45 * (np.log(horsepower) - 4.6)
        - 0.40 * (np.log(weight) - 6.55)
        + np.where(origin == "usa", -0.05, 0.04)
        + rng.normal(0, 0.08, n)
    )
    mpg = np.exp(log_mpg)

    acceleration = np.exp(
        2.75 - 0.30 * (np.log(horsepower) - 4.6) + rng.normal(0, 0.07, n)
    )
    model_year = rng.integers(70, 83, size=n).astype(float)

    name = [f"auto-{i:03d}" for i in range(n)]
    return pd.DataFrame(
        {
            "mpg": mpg,
            "cylinders": cylinders,
            "displacement": displacement,
            "horsepower": horsepower,
            "weight": weight,
            "acceleration": acceleration,
            "model_year": model_year,
            "origin": origin,
            "name": name,
        }
    )


def example_tidy(seed=2021) -> pd.DataFrame:
    """Deterministic lab-style tidy dataset.

    11 named entities × 2 codes × 3 lg10_Z levels, each observed on a smooth
    response surface over (X, Y), with six output parameters (a–f) reported in
    a 'Parameter'/'Value' tidy layout. Mirrors the schema (not the values) of
    the reference example dataset.
    """
    rng = np.random.default_rng(seed)
    names = [
        "intense-opportunity",
        "misty-mountain",
        "golden-harbor",
        "quiet-meadow",
        "rapid-river",
        "silver-summit",
        "crimson-canyon",
        "emerald-estuary",
        "hidden-hollow",
        "bright-basin",
        "velvet-valley",
    ]
    rows = []
    for i, nm in enumerate(names):
        for code in ["P1", "P2"]:
            for lg10_Z in [6.0, 7.0, 8.0]:
                X = float(np.round(rng.uniform(0.1, 0.9), 3))
                Y = float(np.round(np.exp(rng.uniform(np.log(10), np.log(800))), 2))
                phase = 0.4 * i + (0.0 if code == "P1" else 0.7)
                surf = np.sin(2.2 * X + phase) * np.cos(0.4 * np.log(Y)) + 0.15 * (lg10_Z - 7)
                base = {
                    "a": 0.8 * surf + rng.normal(0, 0.05),
                    "b": np.exp(0.35 * surf + rng.normal(0, 0.04)),
                    "c": np.exp(-5.3 + 0.6 * surf + rng.normal(0, 0.05)),
                    "d": np.exp(-0.31 + 0.15 * surf + rng.normal(0, 0.03)),
                    "e": 1 / (1 + np.exp(-(0.5 * surf - 1.0 + rng.normal(0, 0.05)))),
                    "f": np.exp(3.34 + 0.15 * surf + rng.normal(0, 0.03)),
                }
                for param, value in base.items():
                    rows.append(
                        {
                            "Name": nm,
                            "Code": code,
                            "Target": f"T{i % 3}",
                            "Reaction": "std",
                            "X": X,
                            "Y": Y,
                            "lg10_Z": lg10_Z,
                            "Metric": "mean",
                            "Parameter": param,
                            "Value": float(value),
                        }
                    )
    return pd.DataFrame(rows)


def load_dataset(name: str, **kwargs) -> pd.DataFrame:
    """Load a bundled dataset by name ('cars'/'mpg' or 'example')."""
    if name in ("cars", "mpg"):
        return cars(**kwargs)
    if name == "example":
        return example_tidy(**kwargs)
    raise ValueError(f"Unknown dataset {name!r}; available: 'cars', 'example'")


def _ensure_example_pickle() -> pl.Path:
    path = data_dir / "Example_DataSet.pkl"
    if not path.exists():
        example_tidy().to_pickle(path)
    return path


def __getattr__(name):
    # ``example_dataset`` is written on first access, not at import: importing
    # the package writes no file.
    if name == "example_dataset":
        return _ensure_example_pickle()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
