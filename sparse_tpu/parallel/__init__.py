from .pcsr import (  # noqa: F401
    PCSR,
    pcsr_from_csr,
    pcsr_spmm,
    pcsr_spmv,
    pcsr_todense,
    make_1d_mesh,
)
from .cg import (  # noqa: F401
    bicgstab_solve,
    cg_solve,
    chebyshev_preconditioner,
    estimate_lmax,
    gmres_solve,
    pcg_solve,
    power_iteration_step,
)
from .halo import (  # noqa: F401
    HaloPCSR,
    HaloPCSROverlap,
    dist_spmv,
    halo_partition,
    halo_partition_overlapped,
    halo_spmm,
    halo_spmm_overlapped,
    halo_spmv,
    halo_spmv_overlapped,
)
from .pbell import (  # noqa: F401
    PBELL,
    pbell_from_bell,
    pbell_shard_vector,
    pbell_smvm,
    pbell_spmm,
)
from .phub import (  # noqa: F401
    PHubSplit,
    phub_partition,
    phub_spmv,
)
from .pbsr import (  # noqa: F401
    PBSR,
    PBsrSmsmmPlan,
    build_pbsr_smsmm_plan,
    pbsr_from_bsr,
    pbsr_smsmm,
    pbsr_to_bsr,
)
from .pspgemm import (  # noqa: F401
    PSpGEMMPlan,
    PTransposePlan,
    build_pspgemm_plan,
    build_transpose_plan,
    pcsr_spgemm,
    pcsr_spgemm_aa,
    pcsr_transpose,
    pcsr_transpose_device,
)
