"""The mesh paths of the port (the counterpart of ``repro.distributed``):
the ambient parallel context, the sharding rules, the collectives on
``torch.distributed`` process groups, GPipe pipelining and the int8
gradient all-reduce."""
