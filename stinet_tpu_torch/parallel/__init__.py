"""Graph-partition serving over a mesh of partitions (parallel/mesh.py):
the ring halo plan and exchange (halo.py), the partitioned norm and conv
block (sharded_block.py) and the partitioned STINet forward
(sharded_stinet.py)."""
