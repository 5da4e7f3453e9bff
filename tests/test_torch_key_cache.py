"""The key cache of collective_init (sfgwas_tpu_torch/mpc/mhe.py) against
the reference's (sfgwas_tpu/mpc/mhe.py:256-386) at TEST8 with a small
shift set, three parties (dealer 0, data parties 1 and 2, hub 1).

A key directory (key_cache + ".d": meta.npz, rk0.npy, rk1.npy in sorted
Galois order, uint32 residues) written by either package restores in the
other with every array bit-equal to the writer's bundle and
keys_from_cache set; a legacy single .npz in the reference's layout
restores in the port, which migrates it to the directory and removes it;
and three port parties under restored bundles encrypt and decrypt
collectively within TEST8's tolerance."""

import os

import numpy as np
import pytest

from sfgwas_tpu.mpc import mhe as RM
from sfgwas_tpu.parallel import simulate as RS
from sfgwas_tpu.parallel.transport import LocalCluster as RefLocalCluster
from sfgwas_tpu.parallel.transport import Network as RefNetwork
from sfgwas_tpu_torch import interop
from sfgwas_tpu_torch.crypto import basics as PB
from sfgwas_tpu_torch.mpc import mhe as PM
from sfgwas_tpu_torch.parallel import simulate as PS
from sfgwas_tpu_torch.parallel.transport import LocalCluster, Network

PRESET = "TEST8"
SHIFTS = [1, 2, -1]
DEC_TOL = 1e-3  # tests/test_torch_mhe.py's decode tolerance at TEST8


def _u32(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def assert_same_bundle(got, want):
    """Two key bundles (either package's, on the host): the same arrays,
    bit for bit, as uint32 residues."""
    g, w = interop.bundle_arrays(got), interop.bundle_arrays(want)
    np.testing.assert_array_equal(_u32(g["sk"]), _u32(w["sk"]))
    for a, b in zip(g["pk"] + g["rlk"], w["pk"] + w["rlk"]):
        np.testing.assert_array_equal(_u32(a), _u32(b))
    assert sorted(g["rot_keys"]) == sorted(w["rot_keys"]) and len(g["rot_keys"]) >= 3
    for k in g["rot_keys"]:
        for a, b in zip(g["rot_keys"][k], w["rot_keys"][k]):
            np.testing.assert_array_equal(_u32(a), _u32(b))


def port_restore(pid, key_cache):
    """The port's collective_init at one party: a restore needs no peer."""
    net = Network(LocalCluster(3).transport(pid), pid, 3)
    return PM.collective_init(net, PRESET, shifts_override=SHIFTS, key_cache=key_cache,
                              device="cpu")


def ref_restore(pid, key_cache):
    net = RefNetwork(RefLocalCluster(3).transport(pid), pid, 3)
    return RM.collective_init(net, PRESET, shifts_override=SHIFTS, key_cache=key_cache)


@pytest.fixture(scope="module")
def ref_written(tmp_path_factory):
    """The reference's three bundles, each written to its key directory."""
    d = tmp_path_factory.mktemp("ref_keys")
    caches = [str(d / f"keys{p}.npz") for p in range(3)]
    bundles = RS.run_parties(3, lambda mpc: RM.collective_init(
        mpc.net, PRESET, shifts_override=SHIFTS, key_cache=caches[mpc.pid]))
    return bundles, caches


@pytest.fixture(scope="module")
def port_written(tmp_path_factory):
    d = tmp_path_factory.mktemp("port_keys")
    caches = [str(d / f"keys{p}.npz") for p in range(3)]
    bundles = PS.run_network_parties(3, lambda net: PM.collective_init(
        net, PRESET, shifts_override=SHIFTS, key_cache=caches[net.pid], device="cpu"))
    return bundles, caches


@pytest.mark.parametrize("pid", [0, 1, 2])
def test_reference_key_dir_restores_in_port(ref_written, pid):
    bundles, caches = ref_written
    assert not bundles[pid].keys_from_cache
    cps = port_restore(pid, caches[pid])
    assert cps.keys_from_cache and isinstance(cps.enc_rng, np.random.Generator)
    assert cps.sk.s.dtype == cps.rot_keys[min(cps.rot_keys)].d0.dtype
    assert_same_bundle(cps, bundles[pid])


@pytest.mark.parametrize("pid", [0, 1, 2])
def test_port_key_dir_restores_in_reference(port_written, ref_written, pid):
    bundles, caches = port_written
    assert not bundles[pid].keys_from_cache
    kdir = caches[pid] + ".d"
    ref_dir = ref_written[1][pid] + ".d"
    assert sorted(os.listdir(kdir)) == sorted(os.listdir(ref_dir)) == [
        "meta.npz", "rk0.npy", "rk1.npy"]
    with np.load(os.path.join(kdir, "meta.npz")) as z, \
            np.load(os.path.join(ref_dir, "meta.npz")) as r:
        assert sorted(z.files) == sorted(r.files)
        assert all(z[k].dtype == r[k].dtype for k in z.files)
    assert np.load(os.path.join(kdir, "rk0.npy"), mmap_mode="r").dtype == np.uint32
    cps = ref_restore(pid, caches[pid])
    assert cps.keys_from_cache
    assert_same_bundle(cps, bundles[pid])


def test_legacy_npz_migrates(ref_written, tmp_path):
    """The reference's legacy single-zip layout (sk, pk0, pk1, rlk0, rlk1,
    gelems, rk0_<g>, rk1_<g>): restored, migrated to the directory, the
    zip removed; the directory then restores to the same bundle."""
    ref = ref_written[0][1]
    arrs = interop.bundle_arrays(ref)
    path = str(tmp_path / "keys.npz")
    gelems = sorted(arrs["rot_keys"])
    np.savez(path, sk=arrs["sk"], pk0=arrs["pk"][0], pk1=arrs["pk"][1], rlk0=arrs["rlk"][0],
             rlk1=arrs["rlk"][1], gelems=np.asarray(gelems, np.int64),
             **{f"rk{i}_{g}": arrs["rot_keys"][g][i] for g in gelems for i in (0, 1)})
    cps = port_restore(1, path)
    assert cps.keys_from_cache
    assert_same_bundle(cps, ref)
    assert not os.path.exists(path)
    assert os.path.exists(path + ".d/meta.npz")
    again = port_restore(1, path)
    assert again.keys_from_cache
    assert_same_bundle(again, ref)


def test_restored_bundles_decrypt(port_written):
    """Three port parties under bundles restored from the port's key
    directories: each data party encrypts its vector under the collective
    key, the collective decrypt gives it back within TEST8's tolerance."""
    caches = port_written[1]
    vals = {p: np.random.default_rng(20 + p).normal(size=100) for p in (1, 2)}

    def party(net):
        cps = PM.collective_init(net, PRESET, shifts_override=SHIFTS, key_cache=caches[net.pid],
                                 device="cpu")
        assert cps.keys_from_cache
        if net.pid == 0:  # the dealer takes no part in the decrypt
            return None
        out = {}
        for src in (1, 2):
            cts = PB.encrypt_float_vector(cps, vals[src]) if net.pid == src else [None]
            pts = PM.collective_decrypt_many(net, cps, cts, src)
            out[src] = np.concatenate([cps.ctx.decode(pt) for pt in pts])[:100]
        return out

    res = PS.run_network_parties(3, party, timeout=300)
    for pid in (1, 2):
        for src in (1, 2):
            assert np.abs(res[pid][src] - vals[src]).max() < DEC_TOL
