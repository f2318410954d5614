"""Render the documentation images from a synthetic scenario.

Produces docs/imgs/{coverage,rays,scene,power_discarding}.png headlessly.
Run: python examples/generate_docs_imgs.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests"))

import jax

jax.config.update("jax_platforms", "cpu")

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np

import deepmimo_tpu as dm
from scenario_utils import write_synthetic_scenario

OUT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs", "imgs")


def main():
    from deepmimo_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    os.makedirs(OUT, exist_ok=True)
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        folder = os.path.join(tmp, "docs_city")
        write_synthetic_scenario(folder, n_ue=512, max_paths=10, seed=4,
                                 grid=(32, 16))
        ds = dm.load(folder)

        ax = ds.plot_coverage(np.asarray(ds.pathloss),
                              cbar_title="Pathloss (dB)", scat_sz=8)
        ax.figure.savefig(os.path.join(OUT, "coverage.png"), dpi=120)
        plt.close("all")

        idx = int(np.argmax(np.asarray(ds.num_paths)))
        ax = ds.plot_rays(idx)
        ax.figure.savefig(os.path.join(OUT, "rays.png"), dpi=120)
        plt.close("all")

        ds.compute_channels(dm.ChannelGenParameters())
        ax = dm.plot_power_discarding(ds)
        ax.figure.savefig(os.path.join(OUT, "power_discarding.png"),
                          dpi=120)
        plt.close("all")

        from deepmimo_tpu.scene import Scene, Face, PhysicalElement
        scene = Scene()
        rng = np.random.RandomState(0)
        for i in range(12):
            x, y = rng.uniform(-60, 60, 2)
            w, d, h = rng.uniform(8, 20, 3) * (1, 1, 2)
            base = [[x, y, 0], [x + w, y, 0], [x + w, y + d, 0],
                    [x, y + d, 0]]
            top = [[v[0], v[1], h] for v in base]
            faces = [Face(base), Face(top)]
            for a, b in zip(range(4), [1, 2, 3, 0]):
                faces.append(Face([base[a], base[b], top[b], top[a]]))
            scene.add_object(PhysicalElement(faces, label="buildings"))
        ax = scene.plot()
        ax.figure.savefig(os.path.join(OUT, "scene.png"), dpi=120)
        plt.close("all")

    print(f"wrote images to {OUT}")


if __name__ == "__main__":
    main()
