"""PyTorch/CUDA compute core: kernels, likelihoods, optimizers, posteriors."""

from .hopper_kernels import RbfGram, rbf_gram, rbf_gram_plain  # noqa: F401
from .kernels import (  # noqa: F401
    CONTINUOUS_KERNELS,
    CoregTerm,
    GPSpec,
    GPTerm,
    coreg_matrix,
    gram,
    gram_diag,
    noise_diag,
    output_correlation,
)
from .kronecker import KronCache, kron_cache, kron_mll, kron_neg_logp, kron_predict_diag  # noqa: F401
from .linalg import quad_and_logdet, spd_solve  # noqa: F401
from .mll import DEFAULT_JITTER, cholesky_factor, map_neg_logp, mll  # noqa: F401
from .optimize import (  # noqa: F401
    fit_gp_map,
    fit_kron_map,
    lbfgs_backtracking_minimize,
    multi_restart_minimize,
)
from .posterior import (  # noqa: F401
    PosteriorCache,
    posterior_cache,
    predict_diag,
    predict_diag_chunked,
)
from .priors import (  # noqa: F401
    constrain,
    fit_inverse_gamma,
    initial_params,
    log_prior,
    ls_prior_params,
    param_info,
    unconstrain,
)
