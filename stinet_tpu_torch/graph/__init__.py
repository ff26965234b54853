from stinet_tpu_torch.graph.hierarchy import (  # noqa: F401
    EdgeSet, GraphLevel, HierarchicalGraph)
from stinet_tpu_torch.graph.build import (  # noqa: F401
    RawHierarchy, bucket_size, build_hierarchical_graph)
