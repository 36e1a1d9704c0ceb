"""The distributed layer (own copy of ``repro.distributed``): sharding
rules over DTensor, and fault tolerance."""
