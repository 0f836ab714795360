# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: mesh_internal.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x13mesh_internal.proto\x12\x0emmtpu.internal\"\xd5\x01\n\x0eRoutingContext\x12$\n\x03hop\x18\x01 \x01(\x0e\x32\x17.mmtpu.internal.HopType\x12\x15\n\rexclude_serve\x18\x02 \x03(\t\x12\x14\n\x0c\x65xclude_load\x18\x03 \x03(\t\x12\x0f\n\x07visited\x18\x04 \x03(\t\x12\x15\n\rdest_instance\x18\x05 \x01(\t\x12\x18\n\x10\x63hain_load_count\x18\x06 \x01(\r\x12\x18\n\x10known_size_bytes\x18\x07 \x01(\x04\x12\x14\n\x0clast_used_ms\x18\x08 \x01(\x04\"\xe3\x01\n\x0e\x46orwardRequest\x12\x10\n\x08model_id\x18\x01 \x01(\t\x12\x13\n\x0bmethod_name\x18\x02 \x01(\t\x12\x0f\n\x07payload\x18\x03 \x01(\x0c\x12<\n\x07headers\x18\x04 \x03(\x0b\x32+.mmtpu.internal.ForwardRequest.HeadersEntry\x12+\n\x03\x63tx\x18\x05 \x01(\x0b\x32\x1e.mmtpu.internal.RoutingContext\x1a.\n\x0cHeadersEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\xba\x01\n\x0f\x46orwardResponse\x12\x0f\n\x07payload\x18\x01 \x01(\x0c\x12=\n\x07headers\x18\x02 \x03(\x0b\x32,.mmtpu.internal.ForwardResponse.HeadersEntry\x12\x11\n\tserved_by\x18\x03 \x01(\t\x12\x14\n\x0cmodel_status\x18\x04 \x01(\r\x1a.\n\x0cHeadersEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01*H\n\x07HopType\x12\x0c\n\x08\x45XTERNAL\x10\x00\x12\x0c\n\x08INTERNAL\x10\x01\x12\x0c\n\x08HIT_ONLY\x10\x02\x12\x13\n\x0fLOAD_LOCAL_ONLY\x10\x03\x32Z\n\x0cMeshInternal\x12J\n\x07\x46orward\x12\x1e.mmtpu.internal.ForwardRequest\x1a\x1f.mmtpu.internal.ForwardResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'mesh_internal_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _FORWARDREQUEST_HEADERSENTRY._options = None
  _FORWARDREQUEST_HEADERSENTRY._serialized_options = b'8\001'
  _FORWARDRESPONSE_HEADERSENTRY._options = None
  _FORWARDRESPONSE_HEADERSENTRY._serialized_options = b'8\001'
  _HOPTYPE._serialized_start=674
  _HOPTYPE._serialized_end=746
  _ROUTINGCONTEXT._serialized_start=40
  _ROUTINGCONTEXT._serialized_end=253
  _FORWARDREQUEST._serialized_start=256
  _FORWARDREQUEST._serialized_end=483
  _FORWARDREQUEST_HEADERSENTRY._serialized_start=437
  _FORWARDREQUEST_HEADERSENTRY._serialized_end=483
  _FORWARDRESPONSE._serialized_start=486
  _FORWARDRESPONSE._serialized_end=672
  _FORWARDRESPONSE_HEADERSENTRY._serialized_start=437
  _FORWARDRESPONSE_HEADERSENTRY._serialized_end=483
  _MESHINTERNAL._serialized_start=748
  _MESHINTERNAL._serialized_end=838
# @@protoc_insertion_point(module_scope)
