"""K2, the dense multiply-accumulate of the block product
(sfgwas_tpu_torch/csrc/mac_dense.cu, launched by gwas/matmult.py::mac_dense).

Per launch: bytes = the block row's baby rotations R0 and R1 [nb, s, nmod,
N], the diagonal polynomials [K, nmod, N] and each run's accumulator row
read and written (2 x 2 nruns s nmod N), all int32; operations = 2 a
modular multiply-add of each entry (diagonal, baby) into both halves, E
entries x s rows x nmod x N.  The count is chip_smoke.py::_k2_check's,
frozen here."""

DEVICE_NAME = r"mac_dense_kernel"
WRAPS = "sfgwas_tpu_torch.gwas.matmult:mac_dense"


def work(args, kwargs):
    ACC0, _, R0, _, polys, runs = args[:6]
    if ACC0.device.type != "cuda":
        return None
    nb, s, nmod, N = R0.shape
    nruns = len(runs.run_sg_host)
    E = int(runs.run_start_host[-1])
    if nruns == 0 or s == 0:
        return None
    nbytes = 4 * (2 * nb * s * nmod * N + polys.shape[0] * nmod * N + 4 * nruns * s * nmod * N)
    return nbytes, 2 * (2 * E * s * nmod * N)
