"""Multi-device parallelism on ``torch.distributed``: mesh construction and
sharded GP computations (port of ``gumbi_tpu/parallel``).

SPMD: one process per device, a ('restart', 'data') ``DeviceMesh`` from
:func:`make_mesh`, and every rank calling the same functions on the same
global inputs. On one card, ``make_mesh()`` starts a one-rank group itself;
on several, start the ranks with ``torchrun --nproc-per-node N``.
"""

from .blocked import blocked_cholesky, dist_gaussian_logp, dist_quad_and_logdet  # noqa: F401
from .iterative import (  # noqa: F401
    dist_iter_fit_gp_map,
    dist_iter_gaussian_logp,
    dist_iter_map_neg_logp,
    dist_iter_posterior_cache,
    pad_for_dist_iter,
)
from .mesh import make_mesh, replicated, shard_leading  # noqa: F401
from .sharded import (  # noqa: F401
    data_sharded_fit_gp_map,
    sharded_fit_fitc_laplace_map,
    sharded_fit_fitc_map,
    sharded_fit_gp_map,
    sharded_fit_kron_map,
    sharded_fit_laplace_map,
    sharded_gram_mll,
    sharded_predict_diag,
    train_step,
)
