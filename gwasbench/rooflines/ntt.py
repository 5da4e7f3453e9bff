"""K1, the negacyclic NTT (sfgwas_tpu_torch/csrc/ntt.cu, launched by
ops/cuda_ntt.py::ntt_b_kernel), forward and inverse.

Per launch on x [L, B, N] int32: bytes = the input and the output (2 L B N
words) and the two twiddle tables of the L rows (psi and its Shoup
companion, 2 L N words); operations = 3 a modular (Shoup) multiply, N/2
log2 N butterflies a polynomial, and N more multiplies for the inverse's
scaling by 1/N.  The count is chip_smoke.py::_k1_rows's, frozen here."""

DEVICE_NAME = r"ntt_kernel<\d+, (true|false)>"
WRAPS = "sfgwas_tpu_torch.ops.cuda_ntt:ntt_b_kernel"


def work(args, kwargs):
    x, basis = args[0], args[1]
    inverse = bool(args[3] if len(args) > 3 else kwargs.get("inverse", False))
    if x.device.type != "cuda":
        return None
    L, B, N = x.shape
    if B == 0:
        return None
    logn = N.bit_length() - 1
    mults = logn * (N // 2) + (N if inverse else 0)
    return 4 * (2 * L * B * N + 2 * L * N), 3 * L * B * mults
