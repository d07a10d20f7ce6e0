# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: vectorized_map.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x14vectorized_map.proto\x12\x0fprosim_tpu.maps\"(\n\x05Point\x12\t\n\x01x\x18\x01 \x01(\x01\x12\t\n\x01y\x18\x02 \x01(\x01\x12\t\n\x01z\x18\x03 \x01(\x01\"F\n\x08Polyline\x12\r\n\x05\x64x_mm\x18\x01 \x03(\x11\x12\r\n\x05\x64y_mm\x18\x02 \x03(\x11\x12\r\n\x05\x64z_mm\x18\x03 \x03(\x11\x12\r\n\x05h_rad\x18\x04 \x03(\x01\"\xfe\x01\n\x08RoadLane\x12)\n\x06\x63\x65nter\x18\x01 \x01(\x0b\x32\x19.prosim_tpu.maps.Polyline\x12\x30\n\rleft_boundary\x18\x02 \x01(\x0b\x32\x19.prosim_tpu.maps.Polyline\x12\x31\n\x0eright_boundary\x18\x03 \x01(\x0b\x32\x19.prosim_tpu.maps.Polyline\x12\x13\n\x0b\x65ntry_lanes\x18\x04 \x03(\x0c\x12\x12\n\nexit_lanes\x18\x05 \x03(\x0c\x12\x1b\n\x13\x61\x64jacent_lanes_left\x18\x06 \x03(\x0c\x12\x1c\n\x14\x61\x64jacent_lanes_right\x18\x07 \x03(\x0c\"r\n\x08RoadArea\x12\x33\n\x10\x65xterior_polygon\x18\x01 \x01(\x0b\x32\x19.prosim_tpu.maps.Polyline\x12\x31\n\x0einterior_holes\x18\x02 \x03(\x0b\x32\x19.prosim_tpu.maps.Polyline\":\n\x0cPedCrosswalk\x12*\n\x07polygon\x18\x01 \x01(\x0b\x32\x19.prosim_tpu.maps.Polyline\"8\n\nPedWalkway\x12*\n\x07polygon\x18\x01 \x01(\x0b\x32\x19.prosim_tpu.maps.Polyline\"\xf4\x01\n\nMapElement\x12\n\n\x02id\x18\x01 \x01(\x0c\x12.\n\troad_lane\x18\x02 \x01(\x0b\x32\x19.prosim_tpu.maps.RoadLaneH\x00\x12.\n\troad_area\x18\x03 \x01(\x0b\x32\x19.prosim_tpu.maps.RoadAreaH\x00\x12\x36\n\rped_crosswalk\x18\x04 \x01(\x0b\x32\x1d.prosim_tpu.maps.PedCrosswalkH\x00\x12\x32\n\x0bped_walkway\x18\x05 \x01(\x0b\x32\x1b.prosim_tpu.maps.PedWalkwayH\x00\x42\x0e\n\x0c\x65lement_data\"\xcc\x01\n\rVectorizedMap\x12\x0c\n\x04name\x18\x01 \x01(\t\x12-\n\x08\x65lements\x18\x02 \x03(\x0b\x32\x1b.prosim_tpu.maps.MapElement\x12&\n\x06max_pt\x18\x03 \x01(\x0b\x32\x16.prosim_tpu.maps.Point\x12&\n\x06min_pt\x18\x04 \x01(\x0b\x32\x16.prosim_tpu.maps.Point\x12.\n\x0eshifted_origin\x18\x05 \x01(\x0b\x32\x16.prosim_tpu.maps.Pointb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'vectorized_map_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _POINT._serialized_start=41
  _POINT._serialized_end=81
  _POLYLINE._serialized_start=83
  _POLYLINE._serialized_end=153
  _ROADLANE._serialized_start=156
  _ROADLANE._serialized_end=410
  _ROADAREA._serialized_start=412
  _ROADAREA._serialized_end=526
  _PEDCROSSWALK._serialized_start=528
  _PEDCROSSWALK._serialized_end=586
  _PEDWALKWAY._serialized_start=588
  _PEDWALKWAY._serialized_end=644
  _MAPELEMENT._serialized_start=647
  _MAPELEMENT._serialized_end=891
  _VECTORIZEDMAP._serialized_start=894
  _VECTORIZEDMAP._serialized_end=1098
# @@protoc_insertion_point(module_scope)
