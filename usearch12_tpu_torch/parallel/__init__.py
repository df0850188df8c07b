"""The mesh paths of the port: cluster_mt's U counter on the card
(cluster_batch.py), usearch_global's sharded ranking (mesh_search.py) and
the search across processes (multihost.py), over a mesh of torch devices
(mesh.py)."""
