# -*- coding: utf-8 -*-
# Generated by tools/gen_transfer_pb2.py (no protoc in the build image —
# the descriptor is built with the protobuf runtime).  DO NOT EDIT!
# source: mesh_transfer.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database

_sym_db = _symbol_database.Default()


DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x13mesh_transfer.proto\x12\x0emmtpu.transfer"u\n\x13FetchWeightsRequest\x12\x1a\n\x08model_id\x18\x01 \x01(\tR\x08model_id\x12 \n\x0bchunk_index\x18\x02 \x01(\rR\x0bchunk_index\x12 \n\x0bfingerprint\x18\x03 \x01(\tR\x0bfingerprint"\x90\x02\n\x14FetchWeightsResponse\x12\x16\n\x06status\x18\x01 \x01(\rR\x06status\x12\x18\n\x07payload\x18\x02 \x01(\x0cR\x07payload\x12\x10\n\x03seq\x18\x03 \x01(\rR\x03seq\x12\x14\n\x05layer\x18\x04 \x01(\x11R\x05layer\x12\x12\n\x04last\x18\x05 \x01(\x08R\x04last\x12"\n\x0ctotal_chunks\x18\x06 \x01(\rR\x0ctotal_chunks\x12 \n\x0btotal_bytes\x18\x07 \x01(\x04R\x0btotal_bytes\x12"\n\x0ctotal_layers\x18\x08 \x01(\rR\x0ctotal_layers\x12 \n\x0bfingerprint\x18\t \x01(\tR\x0bfingerprintb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'mesh_transfer_pb2', globals())
