"""Generated protobuf modules of the cache's map format and the WOMD
Scenario schema (copies of prosim_tpu/data/protos; the serialized
descriptors are byte-identical, so both packages' modules can load in one
process). Imported as package modules, never through sys.path."""
