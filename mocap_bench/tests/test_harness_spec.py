"""The harness finds each cell's parts by the names BENCHMARK.json gives."""
import json

from bench_support import ROOT

from mocap_bench import spec


def test_every_cell_resolves_its_files_and_metrics():
    bench = spec.load_benchmark()
    for w in bench["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config_name == w["config"] and cell.traffic_name == w["traffic"]
        assert cell.traffic["mode"] in ("offline", "online")
        names = {m.name for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m.moves in names
            assert callable(spec.reader(m.name))
        assert set(cell.limits["limits"]) >= {"decisions_differ", "frames_judged"}


def test_per_layer_metrics_only_where_listed():
    bench = spec.load_benchmark()
    for m in bench["per_layer"]:
        for w in m["workloads"]:
            cell = spec.load_cell(w)
            assert m["name"] in {x.name for x in cell.per_layer}
            assert m["moves"] in {x.name for x in cell.end_to_end}
    off = {m.name for m in spec.load_cell("dome128-tri-offline").per_layer}
    on = {m.name for m in spec.load_cell("rig32-tri-online").per_layer}
    assert all(n.endswith(".offline") for n in off) and all(n.endswith(".online") for n in on)


def test_configuration_files_hold_the_package_defaults():
    """The cells run PipelineConfig's own schedule: every key of a
    configuration file that PipelineConfig has, other than the rig's
    capacities, holds its default."""
    import dataclasses

    from multiview_motion_capture_torch.config import PipelineConfig

    rig_keys = {"n_views", "assoc_clusters", "ik_max_views", "max_frames"}
    defaults = {f.name: f.default for f in dataclasses.fields(PipelineConfig)}
    for c in spec.load_benchmark()["configs"]:
        pipe = json.loads((ROOT / c["file"]).read_text())["pipeline"]
        for k, v in pipe.items():
            assert k in defaults, k
            if k not in rig_keys:
                assert v == defaults[k], (c["name"], k, v, defaults[k])
