"""Configuration: two-level TOML in the Go sfgwas's schema (counterpart of
sfgwas_tpu/utils/config.py, copied: the port imports nothing of the JAX
package).

The Go sfgwas merges configGlobal.toml with configLocal.Party%d.toml into
one struct (gwas/gwas.go:40-117, sfgwas.go:26-53).  Field names match its
TOML keys so existing configs work unchanged.
"""

from __future__ import annotations

import dataclasses
import tomllib
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Config:
    # Parties
    num_main_parties: int = 2
    hub_party_id: int = 1

    # Crypto
    ckks_params: str = "PN14QP438"

    # MPC
    mpc_field_size: int = 256
    mpc_data_bits: int = 60
    mpc_frac_bits: int = 30
    mpc_num_threads: int = 1
    mpc_boolean_shares: bool = True
    div_sqrt_max_len: int = 1_000_000

    # Data dimensions
    num_inds: List[int] = field(default_factory=list)
    num_snps: int = 0
    num_covs: int = 0
    cov_all_ones: bool = False

    # Input files
    geno_file_format: str = "blocks"  # 'blocks' or 'pgen'
    geno_binary_file_prefix: str = ""
    geno_num_blocks: int = 1
    geno_block_size_file: str = ""
    pheno_file: str = ""
    covar_file: str = ""
    snp_position_file: str = ""
    use_precomputed_geno_count: bool = False
    geno_count_file: str = ""
    sample_keep_file: str = ""
    snp_ids_file: str = ""

    # iteration aid: cache the collective key bundle under cache_dir and
    # restore it on later runs (skips interactive keygen; NOT for production)
    use_cached_keys: bool = False

    # QC
    skip_qc: bool = False
    use_cached_qc: bool = False
    imiss_ub: float = 1.0
    het_lb: float = 0.0
    het_ub: float = 1.0
    gmiss: float = 0.1
    maf_lb: float = 0.1
    hwe_ub: float = 28.374
    snp_dist_thres: int = 100000

    # Distributed QR method for the combined covariate basis and the PCA
    # power-iteration orthonormalizations: "cholqr2" (default; Gram in HE +
    # whole-factorization in SS, ~5 collective rounds per invocation),
    # "cholqr3" (extra pass for very ill-conditioned inputs), or
    # "householder" (the reference's per-column NetDQRenc structure,
    # gwas/qrfact.go:47-316).
    qr_method: str = "cholqr2"

    # PCA
    skip_pca: bool = False
    use_cached_pca: bool = False
    skip_power_iter: bool = False
    restart_pca_from_iter: int = 0
    iter_per_eigenval: int = 5
    num_pcs_to_remove: int = 5
    num_oversampling: int = 10
    num_power_iters: int = 20

    # Assoc
    use_cached_combined_q: bool = False
    pgen_batch_nsnp: int = 8192
    blocks_for_assoc_test: List[int] = field(default_factory=list)
    assoc_num_blocks_parallel: int = 1

    # Logistic
    use_logistic: bool = False
    inverse_mat_scale: float = 10000.0
    A: float = -10.0
    B: float = 10.0
    degree: int = 62
    epochs: int = 15

    # Networking
    binding_ipaddr: str = "0.0.0.0"
    servers: Dict[int, dict] = field(default_factory=dict)
    shared_keys_path: str = ""

    # Local (per-party)
    output_dir: str = "out"
    cache_dir: str = "cache"
    local_num_threads: int = 1
    memory_limit: int = 0
    # within-party sharding: distribute the BSGS matmult's block-column MAC
    # chunks over this party's local devices (the JAX package's option; the
    # port's protocol refuses it until the multi-GPU path is ported)
    shard_matmult: bool = False

    debug: bool = False

    @property
    def nparty(self) -> int:
        return self.num_main_parties + 1


def _apply(cfg: Config, data: dict):
    names = {f.name for f in dataclasses.fields(Config)}
    for k, v in data.items():
        if k == "servers":
            servers = {}
            for name, entry in v.items():
                pid = int(name.replace("party", ""))
                ports = {
                    int(p.replace("party", "")): int(port)
                    for p, port in entry.get("ports", {}).items()
                }
                servers[pid] = {"ip": entry.get("ipaddr", "127.0.0.1"), "ports": ports}
            cfg.servers = servers
        elif k == "Degree":
            cfg.degree = int(v)
        elif k in names:
            setattr(cfg, k, v)
        # unknown keys ignored (forward compatibility)
    return cfg


def load_config(global_path: str, local_path: Optional[str] = None) -> Config:
    cfg = Config()
    with open(global_path, "rb") as f:
        _apply(cfg, tomllib.load(f))
    if local_path:
        with open(local_path, "rb") as f:
            _apply(cfg, tomllib.load(f))
    return cfg
