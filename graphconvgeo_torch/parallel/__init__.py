"""Edge-partitioned full-graph training across ``torch.distributed`` ranks
(port of ``graphconvgeo_tpu/parallel``: the mesh, the row partition, the
distributed SpMM, the Highway-GCN and its trainer)."""
