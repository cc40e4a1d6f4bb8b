"""The port's native instance reader on the CPU: twin of
`tests/test_native_io.py`. `parse_instance` must return what the JAX
package's returns on the same files, and the port's `.vrp` / TSPLIB
readers (native path and Python scan) must build the JAX readers'
domains: every customer / location field and the distance matrix, bit for
bit. Skipped only where g++ is missing, as the JAX `lib_ok` fixture skips.
Tolerance: none."""

import numpy as np
import pytest
import torch

import greyjack_tpu.native as jnative
from greyjack_tpu.models.tsp import DomainBuilder as JTspBuilder
from greyjack_tpu.models.vrp import generate_instance as j_generate
from greyjack_tpu.models.vrp.domain import read_vrp_file as j_read_vrp
from greyjack_tpu_torch.models import tsp as ttsp
from greyjack_tpu_torch.models import vrp as tvrp
from greyjack_tpu_torch.models.vrp import domain as tvrp_domain
from greyjack_tpu_torch.models.tsp import domain as ttsp_domain
from greyjack_tpu_torch.native import gjio, native_available, parse_instance

torch.set_num_threads(1)

TSP_TEXT = """NAME : toy5
TYPE : TSP
DIMENSION : 5
EDGE_WEIGHT_TYPE : EUC_2D
NODE_COORD_SECTION
1 0.0 0.0
2 1.5 0.0
3 1.5 2.5
4 0.0 2.5
5 0.75 1.25
EOF
"""

TSP_EXPLICIT_TEXT = """NAME : toy3x
TYPE : TSP
DIMENSION : 3
EDGE_WEIGHT_TYPE : EXPLICIT
NODE_COORD_SECTION
1 0.0 0.0
2 3.0 0.0
3 0.0 4.0
EOF
0 3.25 4.5
3.25 0 5.125
4.5 5.125 0
EOF
"""

VRP_TEXT = """NAME : toy-tw-d1-n4-k2
TYPE : CVRP
DIMENSION : 5
EDGE_WEIGHT_TYPE : EUC_2D
CAPACITY : 30
NODE_COORD_SECTION
1 0.0 0.0
2 1.0 0.0
3 2.0 0.0
4 0.0 1.0
5 0.0 2.0
DEMAND_SECTION
1 0 0 1000 0
2 10 5 100 7
3 12 0 50 3
4 8 10 90 2
5 9 0 80 1
DEPOT_SECTION
1
-1
EOF
"""


def vrp_text(domain):
    """A `.vrp` file of a generated plan: coordinates written with repr, so
    they read back exactly."""
    lines = [f"NAME : {domain.name}", "TYPE : CVRP",
             f"DIMENSION : {len(domain.customers_vec)}",
             "EDGE_WEIGHT_TYPE : EUC_2D",
             f"CAPACITY : {domain.vehicles[0].capacity}",
             "NODE_COORD_SECTION"]
    lines += [f"{c.id} {c.latitude!r} {c.longitude!r}"
              for c in domain.customers_vec]
    lines.append("DEMAND_SECTION")
    for c in domain.customers_vec:
        tw = (f" {c.time_window_start} {c.time_window_end} {c.service_time}"
              if domain.time_windowed else "")
        lines.append(f"{c.id} {c.demand}{tw}")
    lines += ["DEPOT_SECTION"] + [str(d.id) for d in domain.depot_vec]
    return "\n".join(lines + ["-1", "EOF", ""])


def tsp_text(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.0, 100.0, size=(n, 2))
    lines = [f"NAME : uniform{n}", "TYPE : TSP", f"DIMENSION : {n}",
             "EDGE_WEIGHT_TYPE : EUC_2D", "NODE_COORD_SECTION"]
    lines += [f"{i + 1} {float(x)!r} {float(y)!r}"
              for i, (x, y) in enumerate(pts)]
    return "\n".join(lines + ["EOF", ""])


@pytest.fixture(scope="module")
def lib_ok():
    if not native_available():
        pytest.skip("native toolchain unavailable")
    return True


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    texts = {
        "toy.tsp": TSP_TEXT, "toy3x.tsp": TSP_EXPLICIT_TEXT,
        "toy.vrp": VRP_TEXT,
        "gen_tw.vrp": vrp_text(j_generate(40, 3, 6, seed=5,
                                          time_windowed=True)),
        "gen.vrp": vrp_text(j_generate(25, 1, 4, seed=6)),
        "gen.tsp": tsp_text(30, 7),
    }
    for name, text in texts.items():
        (d / name).write_text(text)
    return {name: str(d / name) for name in texts}


def test_builds_into_the_port_build_dir(lib_ok):
    path = gjio.library_path()
    assert path.startswith(gjio._BUILD_DIR)
    assert "libgjio_" in path


@pytest.mark.parametrize("name", ["toy.tsp", "toy3x.tsp", "toy.vrp",
                                  "gen_tw.vrp", "gen.vrp", "gen.tsp"])
def test_parse_instance_matches_jax(lib_ok, files, name):
    want = jnative.parse_instance(files[name])
    got = parse_instance(files[name])
    assert want is not None and set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w, key


def test_parse_toy_files(lib_ok, files):
    r = parse_instance(files["toy.tsp"])
    assert r["name"] == "toy5" and r["edge_weight_type"] == "EUC_2D"
    np.testing.assert_array_equal(r["ids"], [1, 2, 3, 4, 5])
    np.testing.assert_array_equal(r["xs"], [0.0, 1.5, 1.5, 0.0, 0.75])
    r = parse_instance(files["toy.vrp"])
    assert r["vehicles_count"] == 2 and r["capacity"] == 30
    np.testing.assert_array_equal(r["depot_ids"], [1])
    with pytest.raises(IOError, match="failed to open"):
        parse_instance(files["toy.vrp"] + ".missing")


def _no_native(monkeypatch):
    monkeypatch.setattr(jnative, "parse_instance", lambda path: None)
    monkeypatch.setattr(tvrp_domain, "parse_instance", lambda path: None)
    monkeypatch.setattr(ttsp_domain, "parse_instance", lambda path: None)


def assert_plans_equal(j, t):
    assert (t.name, t.time_windowed) == (j.name, j.time_windowed)
    fields = ("id", "vec_id", "latitude", "longitude", "name", "demand",
              "time_window_start", "time_window_end", "service_time")
    for jc, tc in zip(j.customers_vec, t.customers_vec, strict=True):
        assert [getattr(tc, f) for f in fields] == \
            [getattr(jc, f) for f in fields]
    vf = ("depot_vec_id", "work_day_start", "work_day_end", "capacity",
          "max_stops")
    for jv, tv in zip(j.vehicles, t.vehicles, strict=True):
        assert [getattr(tv, f) for f in vf] == [getattr(jv, f) for f in vf]
    assert [c.id for c in t.depot_vec] == [c.id for c in j.depot_vec]
    np.testing.assert_array_equal(t.distance_matrix.numpy(),
                                  np.asarray(j.distance_matrix))


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("name", ["toy.vrp", "gen_tw.vrp", "gen.vrp"])
def test_vrp_reader_matches_jax(lib_ok, files, monkeypatch, name, native):
    if not native:
        _no_native(monkeypatch)
    want = j_read_vrp(files[name])
    got = tvrp.DomainBuilder(files[name], device="cpu") \
        .build_domain_from_scratch()
    assert got.distance_matrix.device.type == "cpu"
    assert_plans_equal(want, got)


def test_vrp_native_equals_scan(lib_ok, files):
    """The two paths agree on a generated file, names included (the ids,
    which is what a file without a name column gives both)."""
    path = files["gen_tw.vrp"]
    assert_plans_equal(tvrp_domain.scan_vrp_file(path, device="cpu"),
                       tvrp_domain.read_vrp_file(path, device="cpu"))


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("name", ["toy.tsp", "toy3x.tsp", "gen.tsp"])
def test_tsp_reader_matches_jax(lib_ok, files, monkeypatch, name, native):
    if not native:
        _no_native(monkeypatch)
    want = JTspBuilder(files[name]).build_domain_from_scratch()
    got = ttsp.DomainBuilder(files[name], device="cpu") \
        .build_domain_from_scratch()
    assert got.name == want.name
    assert [(lc.id, lc.latitude, lc.longitude, lc.name)
            for lc in got.locations_vec] == [
        (lc.id, lc.latitude, lc.longitude, lc.name)
        for lc in want.locations_vec]
    np.testing.assert_array_equal(got.distance_matrix.numpy(),
                                  np.asarray(want.distance_matrix))
    if name == "toy.tsp":
        assert got.distance_matrix[0, 1].item() == 1.5
