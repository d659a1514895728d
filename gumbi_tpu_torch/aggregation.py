"""Tabular data layer: wide/tidy views of a pandas frame and the DataSet.

A copy of the frame classes of ``gumbi_tpu/aggregation.py`` (same bodies).
This module and :mod:`gumbi_tpu_torch.data` are the only ones of the port
that import pandas; :class:`Standardizer` lives in :mod:`.standardizer`,
which does not, and is re-exported here.
"""

from __future__ import annotations

import pandas as pd

from .standardizer import Standardizer

__all__ = ["Standardizer", "TidyData", "WideData", "DataSet"]


class MetaFrame(pd.DataFrame):
    """Shared machinery for :class:`WideData` and :class:`TidyData`.

    A DataFrame subclass that carries a :class:`Standardizer` and output/column
    configuration, exposing standardized (``.z``) and transformed (``.t``)
    views. Slicing degrades to a plain ``pd.DataFrame`` by design.

    Parity: reference gumbi/aggregation.py:488-589.
    """

    _metadata = [
        "outputs",
        "log_vars",
        "logit_vars",
        "isotropic_vars",
        "names_column",
        "values_column",
        "stdzr",
    ]

    def __init__(
        self,
        df=None,
        outputs=None,
        log_vars=None,
        logit_vars=None,
        isotropic_vars=None,
        names_column="Variable",
        values_column="Value",
        stdzr=None,
        **pd_kwargs,
    ):
        super().__init__(self._coerce_df(df, outputs, names_column, values_column), **pd_kwargs)
        self.outputs = outputs
        self.log_vars = log_vars
        self.logit_vars = logit_vars
        self.isotropic_vars = isotropic_vars
        self.names_column = names_column
        self.values_column = values_column
        if stdzr is None:
            stdzr = Standardizer.from_DataFrame(
                self, log_vars=log_vars, logit_vars=logit_vars, isotropic_vars=isotropic_vars
            )
        else:
            self.log_vars = stdzr.log_vars
            self.logit_vars = stdzr.logit_vars
        self.stdzr = stdzr

    @classmethod
    def _coerce_df(cls, df, outputs, names_column, values_column):
        """Hook allowing subclasses to reshape the incoming (wide) frame."""
        return df

    @property
    def _constructor(self):
        # Slices and copies return a plain DataFrame rather than attempting to
        # rebuild the metadata-carrying subclass.
        return pd.DataFrame

    def __repr__(self):
        head = "\n\t".join(
            [f"{self.__class__.__name__}:", f"outputs: {self.outputs}", f"inputs: {self.inputs}"]
        )
        return head + "\n\n" + super().__repr__()

    @property
    def z(self) -> pd.DataFrame:
        """Standardized data values."""
        raise NotImplementedError

    @property
    def t(self) -> pd.DataFrame:
        """Transformed data values."""
        raise NotImplementedError

    @property
    def specs(self) -> dict:
        """Keyword arguments to construct a similar object."""
        return dict(
            outputs=self.outputs,
            names_column=self.names_column,
            values_column=self.values_column,
            stdzr=self.stdzr,
            log_vars=self.log_vars,
            logit_vars=self.logit_vars,
        )

    @property
    def inputs(self) -> list:
        """Columns not listed as outputs."""
        return [col for col in self.columns if col not in self.outputs]

    @property
    def float_inputs(self) -> list:
        """Input columns with float64 dtype."""
        return [col for col in self.inputs if self[col].dtype == "float64"]

    @classmethod
    def _wide_to_tidy_(cls, wide, outputs, names_column="Variable", values_column="Value"):
        inputs = [col for col in wide.columns if col not in outputs]
        return wide.melt(
            id_vars=inputs, value_vars=outputs, var_name=names_column, value_name=values_column
        )

    @classmethod
    def _tidy_to_wide_(cls, tidy, names_column="Variable", values_column="Value"):
        inputs = [col for col in tidy.columns if col not in (names_column, values_column)]
        return (
            tidy.pivot(index=inputs, columns=names_column, values=values_column)
            .reset_index()
            .rename_axis(columns=None)
        )


class WideData(MetaFrame):
    """Wide-form container: one row per observation, one column per output.

    Constructed from a wide-form DataFrame; prefer :class:`DataSet` for user
    code. Parity: reference gumbi/aggregation.py:592-668.
    """

    @property
    def z(self) -> pd.DataFrame:
        df_ = self.copy()
        cols = self.outputs + self.float_inputs
        df_[cols] = df_[cols].apply(self.stdzr.stdz)
        return df_

    @property
    def t(self) -> pd.DataFrame:
        df_ = self.copy()
        cols = self.outputs + self.float_inputs
        df_[cols] = df_[cols].apply(self.stdzr.transform)
        return df_

    def to_tidy(self) -> TidyData:
        """Melt into the tidy view."""
        return TidyData(self, **self.specs)

    @classmethod
    def from_tidy(
        cls,
        tidy,
        outputs=None,
        names_column="Variable",
        values_column="Value",
        stdzr=None,
        log_vars=None,
        logit_vars=None,
    ):
        """Pivot a tidy-form frame into a :class:`WideData`."""
        outputs = outputs if outputs is not None else list(tidy[names_column].unique())
        wide = cls._tidy_to_wide_(tidy, names_column=names_column, values_column=values_column)
        return cls(
            wide,
            outputs=outputs,
            names_column=names_column,
            values_column=values_column,
            stdzr=stdzr,
            log_vars=log_vars,
            logit_vars=logit_vars,
        )


class TidyData(MetaFrame):
    """Tidy-form container: output names/values as two long columns.

    Note: constructed from a **wide-form** DataFrame (melted internally), for
    symmetry with :class:`WideData`. Parity: reference gumbi/aggregation.py:671-743.
    """

    @classmethod
    def _coerce_df(cls, df, outputs, names_column, values_column):
        return cls._wide_to_tidy_(
            df, outputs=outputs, names_column=names_column, values_column=values_column
        )

    def _wide_view(self) -> WideData:
        wide = self._tidy_to_wide_(self, names_column=self.names_column, values_column=self.values_column)
        return WideData(wide, **self.specs)

    @property
    def z(self) -> pd.DataFrame:
        wd = self._wide_view()
        return self._wide_to_tidy_(
            wd.z, outputs=self.outputs, names_column=self.names_column, values_column=self.values_column
        )

    @property
    def t(self) -> pd.DataFrame:
        wd = self._wide_view()
        return self._wide_to_tidy_(
            wd.t, outputs=self.outputs, names_column=self.names_column, values_column=self.values_column
        )

    def to_wide(self) -> WideData:
        """Pivot back into the wide view."""
        return self._wide_view()


class DataSet:
    """User-facing container pairing a wide-form DataFrame with a Standardizer.

    Provides ``.wide`` / ``.tidy`` views (:class:`WideData` / :class:`TidyData`)
    which in turn expose ``.z`` / ``.t`` standardized and transformed values.
    The Standardizer is built automatically from the data unless supplied.

    Parity: reference gumbi/aggregation.py:746-956.

    Parameters
    ----------
    data : pd.DataFrame
        Wide-form data (see :meth:`from_tidy` for tidy input).
    outputs : list
        Columns to treat as outputs.
    names_column, values_column : str
        Column titles used in the tidy view.
    log_vars, logit_vars : list, optional
        Variables treated as log-/logit-normal (ignored if ``stdzr`` given).
    stdzr : Standardizer, optional
    """

    def __init__(
        self,
        data: pd.DataFrame,
        outputs: list,
        names_column: str = "Variable",
        values_column: str = "Value",
        log_vars: list = None,
        logit_vars: list = None,
        isotropic_vars: list = None,
        stdzr: Standardizer = None,
    ):
        self.data = data
        self.outputs = outputs
        self.names_column = names_column
        self.values_column = values_column
        self.log_vars = log_vars
        self.logit_vars = logit_vars
        self.isotropic_vars = isotropic_vars
        self.stdzr = stdzr
        if self.stdzr is None:
            self.stdzr = Standardizer.from_DataFrame(
                self.wide,
                log_vars=self.log_vars,
                logit_vars=self.logit_vars,
                isotropic_vars=self.isotropic_vars,
            )
        else:
            self.log_vars = self.stdzr.log_vars
            self.logit_vars = self.stdzr.logit_vars

    def __repr__(self):
        wide_shape = "[{0} rows x {1} columns]".format(*self.wide.shape)
        tidy_shape = "[{0} rows x {1} columns]".format(*self.tidy.shape)
        return "\n\t".join(
            [
                "DataSet:",
                f"wide: {wide_shape}",
                f"tidy: {tidy_shape}",
                f"outputs: {self.outputs}",
                f"inputs: {self.inputs}",
            ]
        )

    @property
    def specs(self) -> dict:
        """Keyword arguments to construct a similar DataSet."""
        return dict(
            outputs=self.outputs,
            names_column=self.names_column,
            values_column=self.values_column,
            stdzr=self.stdzr,
            log_vars=self.log_vars,
            logit_vars=self.logit_vars,
        )

    @property
    def inputs(self) -> list:
        """Columns not listed as outputs."""
        return [col for col in self.wide.columns if col not in self.outputs]

    @property
    def float_inputs(self) -> list:
        """Input columns with float64 dtype."""
        return [col for col in self.inputs if self.wide[col].dtype == "float64"]

    @property
    def wide(self) -> WideData:
        """Wide-form view of the data."""
        return WideData(self.data, **self.specs)

    @wide.setter
    def wide(self, wide_df: pd.DataFrame):
        assert any(
            output in wide_df.columns for output in self.outputs
        ), f"Dataframe must have at least one of outputs {self.outputs}"
        self.data = wide_df

    @property
    def tidy(self) -> TidyData:
        """Tidy-form view of the data."""
        return TidyData(self.data, **self.specs)

    @tidy.setter
    def tidy(self, tidy_df: pd.DataFrame):
        assert all(
            col in tidy_df.columns for col in (self.names_column, self.values_column)
        ), f"Dataframe must have both columns {[self.names_column, self.values_column]}"
        self.wide = WideData.from_tidy(tidy_df, **self.specs)

    @classmethod
    def from_tidy(
        cls,
        tidy,
        outputs=None,
        names_column="Variable",
        values_column="Value",
        stdzr=None,
        log_vars=None,
        logit_vars=None,
    ):
        """Construct from a tidy-form DataFrame."""
        assert all(
            col in tidy.columns for col in (names_column, values_column)
        ), f"Dataframe must have both columns {[names_column, values_column]}"
        wide = WideData.from_tidy(
            tidy,
            outputs=outputs,
            names_column=names_column,
            values_column=values_column,
            stdzr=stdzr,
            log_vars=log_vars,
            logit_vars=logit_vars,
        )
        return cls(pd.DataFrame(wide), **wide.specs)

    @classmethod
    def from_wide(
        cls,
        wide,
        outputs=None,
        names_column="Variable",
        values_column="Value",
        stdzr=None,
        log_vars=None,
        logit_vars=None,
    ):
        """Construct from a wide-form DataFrame."""
        return cls(
            wide,
            outputs=outputs,
            names_column=names_column,
            values_column=values_column,
            stdzr=stdzr,
            log_vars=log_vars,
            logit_vars=logit_vars,
        )

    def update_stdzr(self):
        """Refresh the Standardizer from the current data and transform lists."""
        self.stdzr.update(
            Standardizer.from_DataFrame(
                self.wide,
                log_vars=self.log_vars,
                logit_vars=self.logit_vars,
                isotropic_vars=self.isotropic_vars,
            )
        )
