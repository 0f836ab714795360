# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: mesh_kv.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rmesh_kv.proto\x12\x08mmtpu.kv\"k\n\x08KeyValue\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x0c\x12\x12\n\ncreate_rev\x18\x03 \x01(\x03\x12\x0f\n\x07mod_rev\x18\x04 \x01(\x03\x12\x0f\n\x07version\x18\x05 \x01(\x03\x12\r\n\x05lease\x18\x06 \x01(\x03\"\x19\n\nGetRequest\x12\x0b\n\x03key\x18\x01 \x01(\t\"<\n\x0bGetResponse\x12\x1e\n\x02kv\x18\x01 \x01(\x0b\x32\x12.mmtpu.kv.KeyValue\x12\r\n\x05\x66ound\x18\x02 \x01(\x08\"@\n\x0cRangeRequest\x12\x0e\n\x06prefix\x18\x01 \x01(\t\x12\x11\n\tstart_key\x18\x02 \x01(\t\x12\r\n\x05limit\x18\x03 \x01(\x03\"0\n\rRangeResponse\x12\x1f\n\x03kvs\x18\x01 \x03(\x0b\x32\x12.mmtpu.kv.KeyValue\"7\n\nPutRequest\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x0c\x12\r\n\x05lease\x18\x03 \x01(\x03\"-\n\x0bPutResponse\x12\x1e\n\x02kv\x18\x01 \x01(\x0b\x32\x12.mmtpu.kv.KeyValue\"\x1c\n\rDeleteRequest\x12\x0b\n\x03key\x18\x01 \x01(\t\"!\n\x0e\x44\x65leteResponse\x12\x0f\n\x07\x64\x65leted\x18\x01 \x01(\x08\"\'\n\x07\x43ompare\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x0f\n\x07version\x18\x02 \x01(\x03\"B\n\x02Op\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x0c\x12\x11\n\tis_delete\x18\x03 \x01(\x08\x12\r\n\x05lease\x18\x04 \x01(\x03\"u\n\nTxnRequest\x12#\n\x08\x63ompares\x18\x01 \x03(\x0b\x32\x11.mmtpu.kv.Compare\x12 \n\non_success\x18\x02 \x03(\x0b\x32\x0c.mmtpu.kv.Op\x12 \n\non_failure\x18\x03 \x03(\x0b\x32\x0c.mmtpu.kv.Op\"E\n\x0bTxnResponse\x12\x11\n\tsucceeded\x18\x01 \x01(\x08\x12#\n\x07results\x18\x02 \x03(\x0b\x32\x12.mmtpu.kv.KeyValue\"1\n\x0cWatchRequest\x12\x0e\n\x06prefix\x18\x01 \x01(\t\x12\x11\n\tstart_rev\x18\x02 \x01(\x03\"r\n\nWatchEvent\x12\'\n\x04type\x18\x01 \x01(\x0e\x32\x19.mmtpu.kv.WatchEvent.Type\x12\x1e\n\x02kv\x18\x02 \x01(\x0b\x32\x12.mmtpu.kv.KeyValue\"\x1b\n\x04Type\x12\x07\n\x03PUT\x10\x00\x12\n\n\x06\x44\x45LETE\x10\x01\"j\n\nWatchBatch\x12$\n\x06\x65vents\x18\x01 \x03(\x0b\x32\x14.mmtpu.kv.WatchEvent\x12\x0e\n\x06resync\x18\x02 \x01(\x08\x12\x12\n\nresync_rev\x18\x03 \x01(\x03\x12\x12\n\nresync_end\x18\x04 \x01(\x08\"\"\n\x11LeaseGrantRequest\x12\r\n\x05ttl_s\x18\x01 \x01(\x01\"&\n\x12LeaseGrantResponse\x12\x10\n\x08lease_id\x18\x01 \x01(\x03\")\n\x15LeaseKeepaliveRequest\x12\x10\n\x08lease_id\x18\x01 \x01(\x03\"\'\n\x16LeaseKeepaliveResponse\x12\r\n\x05\x61live\x18\x01 \x01(\x08\"&\n\x12LeaseRevokeRequest\x12\x10\n\x08lease_id\x18\x01 \x01(\x03\"\x15\n\x13LeaseRevokeResponse2\xc4\x04\n\x06MeshKV\x12\x32\n\x03Get\x12\x14.mmtpu.kv.GetRequest\x1a\x15.mmtpu.kv.GetResponse\x12>\n\x0bRangePrefix\x12\x16.mmtpu.kv.RangeRequest\x1a\x17.mmtpu.kv.RangeResponse\x12\x32\n\x03Put\x12\x14.mmtpu.kv.PutRequest\x1a\x15.mmtpu.kv.PutResponse\x12;\n\x06\x44\x65lete\x12\x17.mmtpu.kv.DeleteRequest\x1a\x18.mmtpu.kv.DeleteResponse\x12\x32\n\x03Txn\x12\x14.mmtpu.kv.TxnRequest\x1a\x15.mmtpu.kv.TxnResponse\x12\x37\n\x05Watch\x12\x16.mmtpu.kv.WatchRequest\x1a\x14.mmtpu.kv.WatchBatch0\x01\x12G\n\nLeaseGrant\x12\x1b.mmtpu.kv.LeaseGrantRequest\x1a\x1c.mmtpu.kv.LeaseGrantResponse\x12S\n\x0eLeaseKeepalive\x12\x1f.mmtpu.kv.LeaseKeepaliveRequest\x1a .mmtpu.kv.LeaseKeepaliveResponse\x12J\n\x0bLeaseRevoke\x12\x1c.mmtpu.kv.LeaseRevokeRequest\x1a\x1d.mmtpu.kv.LeaseRevokeResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'mesh_kv_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _KEYVALUE._serialized_start=27
  _KEYVALUE._serialized_end=134
  _GETREQUEST._serialized_start=136
  _GETREQUEST._serialized_end=161
  _GETRESPONSE._serialized_start=163
  _GETRESPONSE._serialized_end=223
  _RANGEREQUEST._serialized_start=225
  _RANGEREQUEST._serialized_end=289
  _RANGERESPONSE._serialized_start=291
  _RANGERESPONSE._serialized_end=339
  _PUTREQUEST._serialized_start=341
  _PUTREQUEST._serialized_end=396
  _PUTRESPONSE._serialized_start=398
  _PUTRESPONSE._serialized_end=443
  _DELETEREQUEST._serialized_start=445
  _DELETEREQUEST._serialized_end=473
  _DELETERESPONSE._serialized_start=475
  _DELETERESPONSE._serialized_end=508
  _COMPARE._serialized_start=510
  _COMPARE._serialized_end=549
  _OP._serialized_start=551
  _OP._serialized_end=617
  _TXNREQUEST._serialized_start=619
  _TXNREQUEST._serialized_end=736
  _TXNRESPONSE._serialized_start=738
  _TXNRESPONSE._serialized_end=807
  _WATCHREQUEST._serialized_start=809
  _WATCHREQUEST._serialized_end=858
  _WATCHEVENT._serialized_start=860
  _WATCHEVENT._serialized_end=974
  _WATCHEVENT_TYPE._serialized_start=947
  _WATCHEVENT_TYPE._serialized_end=974
  _WATCHBATCH._serialized_start=976
  _WATCHBATCH._serialized_end=1082
  _LEASEGRANTREQUEST._serialized_start=1084
  _LEASEGRANTREQUEST._serialized_end=1118
  _LEASEGRANTRESPONSE._serialized_start=1120
  _LEASEGRANTRESPONSE._serialized_end=1158
  _LEASEKEEPALIVEREQUEST._serialized_start=1160
  _LEASEKEEPALIVEREQUEST._serialized_end=1201
  _LEASEKEEPALIVERESPONSE._serialized_start=1203
  _LEASEKEEPALIVERESPONSE._serialized_end=1242
  _LEASEREVOKEREQUEST._serialized_start=1244
  _LEASEREVOKEREQUEST._serialized_end=1282
  _LEASEREVOKERESPONSE._serialized_start=1284
  _LEASEREVOKERESPONSE._serialized_end=1305
  _MESHKV._serialized_start=1308
  _MESHKV._serialized_end=1888
# @@protoc_insertion_point(module_scope)
