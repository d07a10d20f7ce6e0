# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: waymo_scenario.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x14waymo_scenario.proto\x12\x0fprosim_tpu.womd\"+\n\x08MapPoint\x12\t\n\x01x\x18\x01 \x01(\x01\x12\t\n\x01y\x18\x02 \x01(\x01\x12\t\n\x01z\x18\x03 \x01(\x01\"w\n\x0f\x42oundarySegment\x12\x18\n\x10lane_start_index\x18\x01 \x01(\x05\x12\x16\n\x0elane_end_index\x18\x02 \x01(\x05\x12\x1b\n\x13\x62oundary_feature_id\x18\x03 \x01(\x03\x12\x15\n\rboundary_type\x18\x04 \x01(\x05\"\xc4\x01\n\x0cLaneNeighbor\x12\x12\n\nfeature_id\x18\x01 \x01(\x03\x12\x18\n\x10self_start_index\x18\x02 \x01(\x05\x12\x16\n\x0eself_end_index\x18\x03 \x01(\x05\x12\x1c\n\x14neighbor_start_index\x18\x04 \x01(\x05\x12\x1a\n\x12neighbor_end_index\x18\x05 \x01(\x05\x12\x34\n\nboundaries\x18\x06 \x03(\x0b\x32 .prosim_tpu.womd.BoundarySegment\"\x93\x04\n\nLaneCenter\x12\x17\n\x0fspeed_limit_mph\x18\x01 \x01(\x01\x12\x32\n\x04type\x18\x02 \x01(\x0e\x32$.prosim_tpu.womd.LaneCenter.LaneType\x12\x15\n\rinterpolating\x18\x03 \x01(\x08\x12+\n\x08polyline\x18\x08 \x03(\x0b\x32\x19.prosim_tpu.womd.MapPoint\x12\x17\n\x0b\x65ntry_lanes\x18\t \x03(\x03\x42\x02\x10\x01\x12\x16\n\nexit_lanes\x18\n \x03(\x03\x42\x02\x10\x01\x12\x35\n\x0eleft_neighbors\x18\x0b \x03(\x0b\x32\x1d.prosim_tpu.womd.LaneNeighbor\x12\x36\n\x0fright_neighbors\x18\x0c \x03(\x0b\x32\x1d.prosim_tpu.womd.LaneNeighbor\x12\x39\n\x0fleft_boundaries\x18\r \x03(\x0b\x32 .prosim_tpu.womd.BoundarySegment\x12:\n\x10right_boundaries\x18\x0e \x03(\x0b\x32 .prosim_tpu.womd.BoundarySegment\"]\n\x08LaneType\x12\x12\n\x0eTYPE_UNDEFINED\x10\x00\x12\x10\n\x0cTYPE_FREEWAY\x10\x01\x12\x17\n\x13TYPE_SURFACE_STREET\x10\x02\x12\x12\n\x0eTYPE_BIKE_LANE\x10\x03\"\x82\x03\n\x08RoadLine\x12\x34\n\x04type\x18\x01 \x01(\x0e\x32&.prosim_tpu.womd.RoadLine.RoadLineType\x12+\n\x08polyline\x18\x02 \x03(\x0b\x32\x19.prosim_tpu.womd.MapPoint\"\x92\x02\n\x0cRoadLineType\x12\x10\n\x0cTYPE_UNKNOWN\x10\x00\x12\x1c\n\x18TYPE_BROKEN_SINGLE_WHITE\x10\x01\x12\x1b\n\x17TYPE_SOLID_SINGLE_WHITE\x10\x02\x12\x1b\n\x17TYPE_SOLID_DOUBLE_WHITE\x10\x03\x12\x1d\n\x19TYPE_BROKEN_SINGLE_YELLOW\x10\x04\x12\x1d\n\x19TYPE_BROKEN_DOUBLE_YELLOW\x10\x05\x12\x1c\n\x18TYPE_SOLID_SINGLE_YELLOW\x10\x06\x12\x1c\n\x18TYPE_SOLID_DOUBLE_YELLOW\x10\x07\x12\x1e\n\x1aTYPE_PASSING_DOUBLE_YELLOW\x10\x08\"\xc7\x01\n\x08RoadEdge\x12\x34\n\x04type\x18\x01 \x01(\x0e\x32&.prosim_tpu.womd.RoadEdge.RoadEdgeType\x12+\n\x08polyline\x18\x02 \x03(\x0b\x32\x19.prosim_tpu.womd.MapPoint\"X\n\x0cRoadEdgeType\x12\x10\n\x0cTYPE_UNKNOWN\x10\x00\x12\x1b\n\x17TYPE_ROAD_EDGE_BOUNDARY\x10\x01\x12\x19\n\x15TYPE_ROAD_EDGE_MEDIAN\x10\x02\"E\n\x08StopSign\x12\x0c\n\x04lane\x18\x01 \x03(\x03\x12+\n\x08position\x18\x02 \x01(\x0b\x32\x19.prosim_tpu.womd.MapPoint\"7\n\tCrosswalk\x12*\n\x07polygon\x18\x01 \x03(\x0b\x32\x19.prosim_tpu.womd.MapPoint\"7\n\tSpeedBump\x12*\n\x07polygon\x18\x01 \x03(\x0b\x32\x19.prosim_tpu.womd.MapPoint\"6\n\x08\x44riveway\x12*\n\x07polygon\x18\x01 \x03(\x0b\x32\x19.prosim_tpu.womd.MapPoint\"\xf7\x02\n\nMapFeature\x12\n\n\x02id\x18\x01 \x01(\x03\x12+\n\x04lane\x18\x03 \x01(\x0b\x32\x1b.prosim_tpu.womd.LaneCenterH\x00\x12.\n\troad_line\x18\x04 \x01(\x0b\x32\x19.prosim_tpu.womd.RoadLineH\x00\x12.\n\troad_edge\x18\x05 \x01(\x0b\x32\x19.prosim_tpu.womd.RoadEdgeH\x00\x12.\n\tstop_sign\x18\x07 \x01(\x0b\x32\x19.prosim_tpu.womd.StopSignH\x00\x12/\n\tcrosswalk\x18\x08 \x01(\x0b\x32\x1a.prosim_tpu.womd.CrosswalkH\x00\x12\x30\n\nspeed_bump\x18\t \x01(\x0b\x32\x1a.prosim_tpu.womd.SpeedBumpH\x00\x12-\n\x08\x64riveway\x18\n \x01(\x0b\x32\x19.prosim_tpu.womd.DrivewayH\x00\x42\x0e\n\x0c\x66\x65\x61ture_data\"\x86\x03\n\x16TrafficSignalLaneState\x12\x0c\n\x04lane\x18\x01 \x01(\x03\x12<\n\x05state\x18\x02 \x01(\x0e\x32-.prosim_tpu.womd.TrafficSignalLaneState.State\x12-\n\nstop_point\x18\x03 \x01(\x0b\x32\x19.prosim_tpu.womd.MapPoint\"\xf0\x01\n\x05State\x12\x16\n\x12LANE_STATE_UNKNOWN\x10\x00\x12\x19\n\x15LANE_STATE_ARROW_STOP\x10\x01\x12\x1c\n\x18LANE_STATE_ARROW_CAUTION\x10\x02\x12\x17\n\x13LANE_STATE_ARROW_GO\x10\x03\x12\x13\n\x0fLANE_STATE_STOP\x10\x04\x12\x16\n\x12LANE_STATE_CAUTION\x10\x05\x12\x11\n\rLANE_STATE_GO\x10\x06\x12\x1c\n\x18LANE_STATE_FLASHING_STOP\x10\x07\x12\x1f\n\x1bLANE_STATE_FLASHING_CAUTION\x10\x08\"O\n\x0f\x44ynamicMapState\x12<\n\x0blane_states\x18\x01 \x03(\x0b\x32\'.prosim_tpu.womd.TrafficSignalLaneState\"\xba\x01\n\x0bObjectState\x12\x10\n\x08\x63\x65nter_x\x18\x02 \x01(\x01\x12\x10\n\x08\x63\x65nter_y\x18\x03 \x01(\x01\x12\x10\n\x08\x63\x65nter_z\x18\x04 \x01(\x01\x12\x0e\n\x06length\x18\x05 \x01(\x02\x12\r\n\x05width\x18\x06 \x01(\x02\x12\x0e\n\x06height\x18\x07 \x01(\x02\x12\x0f\n\x07heading\x18\x08 \x01(\x02\x12\x12\n\nvelocity_x\x18\t \x01(\x02\x12\x12\n\nvelocity_y\x18\n \x01(\x02\x12\r\n\x05valid\x18\x0b \x01(\x08\"\xe0\x01\n\x05Track\x12\n\n\x02id\x18\x01 \x01(\x05\x12\x36\n\x0bobject_type\x18\x02 \x01(\x0e\x32!.prosim_tpu.womd.Track.ObjectType\x12,\n\x06states\x18\x03 \x03(\x0b\x32\x1c.prosim_tpu.womd.ObjectState\"e\n\nObjectType\x12\x0e\n\nTYPE_UNSET\x10\x00\x12\x10\n\x0cTYPE_VEHICLE\x10\x01\x12\x13\n\x0fTYPE_PEDESTRIAN\x10\x02\x12\x10\n\x0cTYPE_CYCLIST\x10\x03\x12\x0e\n\nTYPE_OTHER\x10\x04\"\xa9\x01\n\x12RequiredPrediction\x12\x13\n\x0btrack_index\x18\x01 \x01(\x05\x12G\n\ndifficulty\x18\x02 \x01(\x0e\x32\x33.prosim_tpu.womd.RequiredPrediction.DifficultyLevel\"5\n\x0f\x44ifficultyLevel\x12\x08\n\x04NONE\x10\x00\x12\x0b\n\x07LEVEL_1\x10\x01\x12\x0b\n\x07LEVEL_2\x10\x02\"\xe6\x02\n\x08Scenario\x12\x1a\n\x12timestamps_seconds\x18\x01 \x03(\x01\x12&\n\x06tracks\x18\x02 \x03(\x0b\x32\x16.prosim_tpu.womd.Track\x12\x13\n\x0bscenario_id\x18\x05 \x01(\t\x12\x17\n\x0fsdc_track_index\x18\x06 \x01(\x05\x12<\n\x12\x64ynamic_map_states\x18\x07 \x03(\x0b\x32 .prosim_tpu.womd.DynamicMapState\x12\x31\n\x0cmap_features\x18\x08 \x03(\x0b\x32\x1b.prosim_tpu.womd.MapFeature\x12\x1b\n\x13objects_of_interest\x18\t \x03(\x05\x12\x1a\n\x12\x63urrent_time_index\x18\n \x01(\x05\x12>\n\x11tracks_to_predict\x18\x0b \x03(\x0b\x32#.prosim_tpu.womd.RequiredPrediction')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'waymo_scenario_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _LANECENTER.fields_by_name['entry_lanes']._options = None
  _LANECENTER.fields_by_name['entry_lanes']._serialized_options = b'\020\001'
  _LANECENTER.fields_by_name['exit_lanes']._options = None
  _LANECENTER.fields_by_name['exit_lanes']._serialized_options = b'\020\001'
  _MAPPOINT._serialized_start=41
  _MAPPOINT._serialized_end=84
  _BOUNDARYSEGMENT._serialized_start=86
  _BOUNDARYSEGMENT._serialized_end=205
  _LANENEIGHBOR._serialized_start=208
  _LANENEIGHBOR._serialized_end=404
  _LANECENTER._serialized_start=407
  _LANECENTER._serialized_end=938
  _LANECENTER_LANETYPE._serialized_start=845
  _LANECENTER_LANETYPE._serialized_end=938
  _ROADLINE._serialized_start=941
  _ROADLINE._serialized_end=1327
  _ROADLINE_ROADLINETYPE._serialized_start=1053
  _ROADLINE_ROADLINETYPE._serialized_end=1327
  _ROADEDGE._serialized_start=1330
  _ROADEDGE._serialized_end=1529
  _ROADEDGE_ROADEDGETYPE._serialized_start=1441
  _ROADEDGE_ROADEDGETYPE._serialized_end=1529
  _STOPSIGN._serialized_start=1531
  _STOPSIGN._serialized_end=1600
  _CROSSWALK._serialized_start=1602
  _CROSSWALK._serialized_end=1657
  _SPEEDBUMP._serialized_start=1659
  _SPEEDBUMP._serialized_end=1714
  _DRIVEWAY._serialized_start=1716
  _DRIVEWAY._serialized_end=1770
  _MAPFEATURE._serialized_start=1773
  _MAPFEATURE._serialized_end=2148
  _TRAFFICSIGNALLANESTATE._serialized_start=2151
  _TRAFFICSIGNALLANESTATE._serialized_end=2541
  _TRAFFICSIGNALLANESTATE_STATE._serialized_start=2301
  _TRAFFICSIGNALLANESTATE_STATE._serialized_end=2541
  _DYNAMICMAPSTATE._serialized_start=2543
  _DYNAMICMAPSTATE._serialized_end=2622
  _OBJECTSTATE._serialized_start=2625
  _OBJECTSTATE._serialized_end=2811
  _TRACK._serialized_start=2814
  _TRACK._serialized_end=3038
  _TRACK_OBJECTTYPE._serialized_start=2937
  _TRACK_OBJECTTYPE._serialized_end=3038
  _REQUIREDPREDICTION._serialized_start=3041
  _REQUIREDPREDICTION._serialized_end=3210
  _REQUIREDPREDICTION_DIFFICULTYLEVEL._serialized_start=3157
  _REQUIREDPREDICTION_DIFFICULTYLEVEL._serialized_end=3210
  _SCENARIO._serialized_start=3213
  _SCENARIO._serialized_end=3571
# @@protoc_insertion_point(module_scope)
