"""PyTorch/CUDA compute core: kernels, likelihoods, optimizers, posteriors."""

from .acquisition import (  # noqa: F401
    expected_improvement,
    hv_dominated_mc,
    optimize_acqf,
    optimize_qlog_nei,
    qlog_nehvi_2d,
    qlog_nehvi_mc,
    qlog_nei,
    sobol_normal,
    sobol_uniform,
    upper_confidence_bound,
)
from .ess import bernoulli_loglik, ess_gpc_sample, latent_conditional_proba  # noqa: F401
from .fitc import (  # noqa: F401
    fitc_draw_samples,
    fitc_mll,
    fitc_neg_logp,
    fitc_predict,
    fitc_predict_cov,
    kmeans_inducing,
    select_inducing,
)
from .fitc_laplace import (  # noqa: F401
    fitc_laplace_draw_latent,
    fitc_laplace_mll,
    fitc_laplace_neg_logp,
    fitc_laplace_predict,
)
from .hmc import chees_sample, hmc_sample  # noqa: F401
from .hopper_chol import BlockedChol, cholesky_plain, hopper_cholesky, seam_cholesky  # noqa: F401
from .hopper_kernels import (  # noqa: F401
    FUSABLE_KERNELS,
    FusedMatvec,
    FusedMatvecSym,
    RbfGram,
    fused_matvec_plain,
    fused_stationary_matvec,
    fused_stationary_matvec_sym,
    rbf_gram,
    rbf_gram_plain,
    sym_matvec_fits,
)
from .iterative import (  # noqa: F401
    IterConfig,
    draw_probes,
    fit_iter_map,
    iter_gaussian_logp,
    iter_map_neg_logp,
    iter_map_value,
    iter_map_value_and_grad,
    iter_posterior_cache,
    iter_predict_diag,
    iter_predict_mean,
)
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
from .laplace import (  # noqa: F401
    laplace_draw_latent,
    laplace_mll,
    laplace_mode,
    laplace_neg_logp,
    laplace_neg_logp_chains,
    laplace_predict,
)
from .linalg import quad_and_logdet, spd_solve  # noqa: F401
from .mll import (  # noqa: F401
    DEFAULT_JITTER,
    blocked_gaussian_logp,
    cholesky_factor,
    map_neg_logp,
    map_neg_logp_blocked,
    map_neg_logp_chains,
    mll,
)
from .optimize import (  # noqa: F401
    coarse_restart_map,
    fit_fitc_laplace_map,
    fit_gp_map,
    fit_kron_map,
    fit_laplace_map,
    lbfgs_backtracking_minimize,
    multi_restart_minimize,
)
from .posterior import (  # noqa: F401
    PosteriorCache,
    draw_samples,
    posterior_cache,
    predict_cov,
    predict_cov_level,
    predict_diag,
    predict_diag_chunked,
    predict_diag_level,
)
from .priors import (  # noqa: F401
    constrain,
    fit_inverse_gamma,
    initial_params,
    log_prior,
    log_prior_chains,
    ls_prior_params,
    param_info,
    unconstrain,
)
