"""Documentation coverage: every public API symbol appears in docs/api/.

The reference ships a 10-page docs/api tree (reference docs/api/
generator.md etc.); this build mirrors it with its own surfaces. This test
pins the VERDICT round-2 'done' criterion: every name in
deepmimo_tpu.__all__ (plus the parallel/ops surfaces new to the accelerator build)
is documented somewhere under docs/api/.
"""

import glob
import os

import deepmimo_tpu as dm

DOCS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs", "api")


def _all_docs_text():
    text = ""
    for path in glob.glob(os.path.join(DOCS, "*.md")):
        with open(path) as f:
            text += f.read()
    return text


def test_docs_tree_exists():
    pages = {os.path.basename(p) for p in
             glob.glob(os.path.join(DOCS, "*.md"))}
    # the reference's 10-page set, adapted, plus the JAX-native surfaces
    for page in ("index.md", "generator.md", "ops.md", "parallel.md",
                 "converter.md", "database.md", "scene.md", "materials.md",
                 "config.md", "utils.md", "visualization.md",
                 "integrations.md", "pipelines.md"):
        assert page in pages, page


def test_every_public_symbol_documented():
    text = _all_docs_text()
    missing = [name for name in dm.__all__ if name not in text]
    assert not missing, f"undocumented public symbols: {missing}"


def test_parallel_and_ops_surfaces_documented():
    text = _all_docs_text()
    for name in ("make_mesh", "render_channels_sharded", "shard_paths",
                 "load_paths_sharded", "host_user_range",
                 "training_step_planes", "render_channels_planes",
                 "unpack_planes_np", "rotate_angles", "rotate_unit_vec",
                 "apply_fov", "array_response", "pattern_gain",
                 "PathData", "AntennaPanel", "ChannelConfig",
                 "export_cdl", "read_v3_scenario", "export_matlab"):
        assert name in text, name


def test_doc_examples_name_real_attributes():
    """Spot-check that documented attribute/method names exist."""
    from deepmimo_tpu.generator.dataset import Dataset
    for attr in ("compute_channels", "subset", "apply_fov",
                 "get_uniform_idxs", "get_active_idxs", "plot_coverage",
                 "plot_rays", "info"):
        assert hasattr(Dataset, attr), attr
    from deepmimo_tpu import parallel as par
    for attr in ("make_mesh", "render_channels_sharded",
                 "training_step_planes"):
        assert hasattr(par, attr), attr
    from deepmimo_tpu.utils import profiling
    for attr in ("StageTimer", "xla_trace", "renderer_roofline"):
        assert hasattr(profiling, attr), attr


def test_manual_notebook_in_sync():
    """docs/manual.ipynb is GENERATED from docs/manual.md (the reference
    ships its manual as a notebook); the committed notebook must match a
    fresh regeneration so the two can never drift."""
    import json
    import os
    import sys

    docs = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "docs")
    sys.path.insert(0, docs)
    try:
        import make_manual_ipynb as gen
    finally:
        sys.path.remove(docs)
    with open(os.path.join(docs, "manual.md")) as f:
        fresh = gen.build_notebook(f.read())
    with open(os.path.join(docs, "manual.ipynb")) as f:
        committed = json.load(f)
    assert committed == fresh
    kinds = [c["cell_type"] for c in committed["cells"]]
    assert "code" in kinds and "markdown" in kinds
