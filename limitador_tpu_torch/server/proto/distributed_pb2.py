# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: limitador/service/distributed/v1/distributed.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from ._pool import POOL
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = POOL.AddSerializedFile(b'\n2limitador/service/distributed/v1/distributed.proto\x12 limitador.service.distributed.v1\"\x9a\x03\n\x06Packet\x12\x38\n\x05hello\x18\x01 \x01(\x0b\x32\'.limitador.service.distributed.v1.HelloH\x00\x12O\n\x11membership_update\x18\x02 \x01(\x0b\x32\x32.limitador.service.distributed.v1.MembershipUpdateH\x00\x12\x37\n\x04ping\x18\x03 \x01(\x0b\x32\'.limitador.service.distributed.v1.EmptyH\x00\x12\x36\n\x04pong\x18\x04 \x01(\x0b\x32&.limitador.service.distributed.v1.PongH\x00\x12I\n\x0e\x63ounter_update\x18\x05 \x01(\x0b\x32/.limitador.service.distributed.v1.CounterUpdateH\x00\x12>\n\x0bre_sync_end\x18\x06 \x01(\x0b\x32\'.limitador.service.distributed.v1.EmptyH\x00\x42\t\n\x07message\"`\n\x05Hello\x12\x16\n\x0esender_peer_id\x18\x01 \x01(\t\x12\x13\n\x0bsender_urls\x18\x02 \x03(\t\x12\x19\n\x0creceiver_url\x18\x03 \x01(\tH\x00\x88\x01\x01\x42\x0f\n\r_receiver_url\"\x07\n\x05\x45mpty\"\x1c\n\x04Pong\x12\x14\n\x0c\x63urrent_time\x18\x03 \x01(\x04\"I\n\x10MembershipUpdate\x12\x35\n\x05peers\x18\x01 \x03(\x0b\x32&.limitador.service.distributed.v1.Peer\"6\n\x04Peer\x12\x0f\n\x07peer_id\x18\x01 \x01(\t\x12\x0f\n\x07latency\x18\x02 \x01(\r\x12\x0c\n\x04urls\x18\x03 \x03(\t\"\xac\x01\n\rCounterUpdate\x12\x0b\n\x03key\x18\x01 \x01(\x0c\x12K\n\x06values\x18\x02 \x03(\x0b\x32;.limitador.service.distributed.v1.CounterUpdate.ValuesEntry\x12\x12\n\nexpires_at\x18\x03 \x01(\x04\x1a-\n\x0bValuesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x04:\x02\x38\x01\x32q\n\x0bReplication\x12\x62\n\x06Stream\x12(.limitador.service.distributed.v1.Packet\x1a(.limitador.service.distributed.v1.Packet\"\x00(\x01\x30\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'limitador_tpu_torch.server.proto.distributed_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _COUNTERUPDATE_VALUESENTRY._options = None
  _COUNTERUPDATE_VALUESENTRY._serialized_options = b'8\001'
  _PACKET._serialized_start=89
  _PACKET._serialized_end=499
  _HELLO._serialized_start=501
  _HELLO._serialized_end=597
  _EMPTY._serialized_start=599
  _EMPTY._serialized_end=606
  _PONG._serialized_start=608
  _PONG._serialized_end=636
  _MEMBERSHIPUPDATE._serialized_start=638
  _MEMBERSHIPUPDATE._serialized_end=711
  _PEER._serialized_start=713
  _PEER._serialized_end=767
  _COUNTERUPDATE._serialized_start=770
  _COUNTERUPDATE._serialized_end=942
  _COUNTERUPDATE_VALUESENTRY._serialized_start=897
  _COUNTERUPDATE_VALUESENTRY._serialized_end=942
  _REPLICATION._serialized_start=944
  _REPLICATION._serialized_end=1057
# @@protoc_insertion_point(module_scope)
