"""DeepMIMO in JAX: a site-specific MIMO channel generation framework.

A from-scratch JAX/XLA/Pallas re-design of the DeepMIMO toolchain: ray-tracer
outputs -> standardized scenarios -> batched, differentiable, sharded MIMO
channel synthesis on the GPU.
"""

__version__ = "0.1.0"

from . import consts
from .config import config

# Compute core
from .ops import (
    PathData,
    AntennaPanel,
    ChannelConfig,
    render_channels,
    render_channels_and_grads,
    steering_vec,
)

# Utilities
from .utils import (
    DotDict,
    get_available_scenarios,
    get_params_path,
    get_scenario_folder,
    load_dict_from_json,
    zip,
    unzip,
)

# Generator layer (Dataset, load/generate) — imported lazily below to keep
# `import deepmimo_tpu` light; these are the primary user entry points.
from .generator import (
    Dataset,
    MacroDataset,
    ChannelGenParameters,
    load,
    generate,
    LinearPath,
    get_idxs_with_limits,
    get_uniform_idxs,
)

from .generator.visualization import (
    plot_coverage,
    plot_rays,
    plot_power_discarding,
)

from .txrx import (
    TxRxSet,
    TxRxPair,
    get_txrx_sets,
    get_txrx_pairs,
    print_available_txrx_pair_ids,
)

from .materials import Material, MaterialList
from .scene import Face, PhysicalElement, PhysicalElementGroup, Scene

from .converter import convert
from .integrations import DeepMIMOSionnaAdapter, export_matlab
from .info import info
from .summary import summary, plot_summary
from .api import upload, upload_rt_source, upload_images, download, search

# Module aliases for drop-in parity with the reference's public surface
# (reference exposes `deepmimo.general_utils` / `deepmimo.rt_params` as
# importable module attributes, __init__.py:85-148).
from . import rt_params
from . import utils as general_utils

__all__ = [
    # Core
    "generate", "load", "convert", "info",
    "Dataset", "MacroDataset", "ChannelGenParameters",
    # Compute core
    "PathData", "AntennaPanel", "ChannelConfig",
    "render_channels", "render_channels_and_grads", "steering_vec",
    # TX/RX
    "TxRxSet", "TxRxPair", "get_txrx_sets", "get_txrx_pairs",
    "print_available_txrx_pair_ids",
    # Visualization
    "plot_coverage", "plot_rays", "plot_power_discarding",
    # Utilities
    "LinearPath", "get_idxs_with_limits", "get_uniform_idxs",
    "DotDict", "get_available_scenarios", "get_params_path",
    "get_scenario_folder", "load_dict_from_json", "zip", "unzip",
    # Scene / materials
    "Face", "PhysicalElement", "PhysicalElementGroup", "Scene",
    "Material", "MaterialList",
    # Integrations
    "DeepMIMOSionnaAdapter", "export_matlab",
    # Summary / database
    "summary", "plot_summary",
    "upload", "upload_rt_source", "upload_images", "download", "search",
    # Constants and configuration
    "consts", "config",
]
