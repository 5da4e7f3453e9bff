"""The mixed deployment of tests/test_torch_mixed_tcp.py with the other
split: the port's dealer 0 and hub 1 with the reference's party 2, each
its own process over loopback TCP, on the CPU at TEST8 with the scan QC
route.  The revealed filter equals the plaintext QC oracle at every party,
each data party's statistics lie within 2e-2 of the plaintext oracle (corr >
0.999), and the two data parties' statistics within 2e-3 of each other."""

from test_torch_mixed_tcp import run_mixed


def test_port_dealer_and_hub_with_reference_party(tmp_path):
    run_mixed(tmp_path, ["port", "port", "ref"])
