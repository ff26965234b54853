"""Offline preprocessing: ScanNet meshes to graph hierarchies, training
crops and masks (`cli.py`), and texture-map optimization on the card
(`texture_optimization.py`). The host modules are copies of the JAX
package's `stinet_tpu/preprocessing/` over the port's native libraries."""
from stinet_tpu_torch.preprocessing import native  # noqa: F401
from stinet_tpu_torch.preprocessing.graph_levels import (  # noqa: F401
    process_scene, build_scene_levels, edges_from_faces, vertex_normals)
from stinet_tpu_torch.preprocessing.dilation import (  # noqa: F401
    compute_all_node_dilated_edges)
from stinet_tpu_torch.preprocessing.masks import (  # noqa: F401
    generate_masks_for_scene, circle_mask)
from stinet_tpu_torch.preprocessing.crops import (  # noqa: F401
    process_scene_crops)
