"""Per-shard field I/O of the port (tlab_tpu_torch/io/sharded.py) on four
CPU ranks: the manifest and .shard<k>.npy layout of tlab_tpu/io/sharded.py,
so that each package reads the other's files.  A (2, nx, ny, nz) stack
written by the ranks reads back whole (read_sharded) and block by block
(read_sharded_to), and through tlab_tpu's readers; tlab_tpu's files of the
same stack on its virtual 2x2 mesh read back through the port's."""
import json

import numpy as np
import pytest

import test_torch_mesh_workers as W
from tlab_tpu_torch.io import sharded
from tlab_tpu_torch.parallel import mesh as pmesh

PX, PZ = 2, 2
ARR = np.random.default_rng(8).standard_normal((2, 8, 3, 8))


def _block(r):
    ix, iz = divmod(r, PZ)
    nxl, nzl = ARR.shape[1] // PX, ARR.shape[3] // PZ
    return ARR[:, ix * nxl:(ix + 1) * nxl, :, iz * nzl:(iz + 1) * nzl]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(port prefix, tlab_tpu prefix, the port ranks' blocks read back from
    their own files, and from tlab_tpu's)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as PS
    from tlab_tpu.io import sharded as jsh
    from tlab_tpu.parallel import make_mesh
    top = tmp_path_factory.mktemp("sharded")
    jpre = str(top / "jax" / "field")
    (top / "jax").mkdir()
    mesh = make_mesh(PX, PZ, devices=jax.devices()[:PX * PZ])
    jsh.write_sharded(jpre, jax.device_put(
        jnp.asarray(ARR), NamedSharding(mesh, PS(None, "x", None, "z"))),
        {"itime": 3})
    ppre = str(top / "port" / "field")
    (top / "port").mkdir()
    own = pmesh.spawn(W.sharded_job, PX, PZ, "cpu", ARR, ppre, ppre,
                      store_dir=str(top), timeout_s=300)
    theirs = pmesh.spawn(W.sharded_job, PX, PZ, "cpu", ARR,
                         str(top / "port" / "again"), jpre,
                         store_dir=str(top), timeout_s=300)
    return ppre, jpre, own, theirs


def test_round_trip(files):
    ppre, _, own, _ = files
    whole, params = sharded.read_sharded(ppre)
    assert np.array_equal(whole, ARR)
    assert params == {"itime": 3, "rtime": 0.5}
    for r, blk in enumerate(own):
        assert np.array_equal(blk, _block(r)), r
    man = json.load(open(ppre + ".manifest.json"))
    assert man["n_shards"] == PX * PZ and man["dtype"] == "float64"
    assert man["shards"][1]["index"] == [[0, 2], [0, 4], [0, 3], [4, 8]]


def test_tlab_tpu_reads_the_port_files(files):
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as PS
    from tlab_tpu.io import sharded as jsh
    from tlab_tpu.parallel import make_mesh
    ppre = files[0]
    whole, params = jsh.read_sharded(ppre)
    assert np.array_equal(whole, ARR) and params["itime"] == 3
    mesh = make_mesh(PX, PZ, devices=jax.devices()[:PX * PZ])
    got = jsh.read_sharded_to(ppre, NamedSharding(
        mesh, PS(None, "x", None, "z")))
    assert np.array_equal(np.asarray(got), ARR)
    assert jnp.asarray(got).dtype == jnp.float64


def test_state_restart(files):
    """write_state_sharded: flow.5.{1,2,3} and scal.5.1 with the run's
    time, viscosity and iteration."""
    ppre = files[0]
    for name, want in (("flow.5.1", ARR[0]), ("flow.5.2", ARR[1]),
                       ("flow.5.3", -ARR[0]), ("scal.5.1", ARR[1])):
        got, params = sharded.read_sharded(f"{ppre}.{name}")
        assert np.array_equal(got, want), name
        assert params == {"rtime": 0.25, "visc": 1e-3, "itime": 5}


def test_the_port_reads_tlab_tpu_files(files):
    _, jpre, _, theirs = files
    whole, params = sharded.read_sharded(jpre)
    assert np.array_equal(whole, ARR) and params == {"itime": 3}
    for r, blk in enumerate(theirs):
        assert np.array_equal(blk, _block(r)), r
