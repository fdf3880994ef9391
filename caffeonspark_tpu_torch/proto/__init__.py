"""Protobuf schema + runtime (text format / binary wire) for Caffe messages.

Equivalent of the reference's protobuf-java + caffe.proto usage
(`jcaffe/Utils.java:11-27`); see `descriptor.py` and `caffe.py`.
"""

from . import caffe
from .caffe import (BlobProto, BlobProtoVector, BlobShape, CoSDataParameter,
                    Datum, FillerParameter, LayerParameter, NetParameter,
                    NetState, NetStateRule, ParamSpec, Phase, SolverParameter,
                    SolverState, TopBlob, TopBlobType,
                    TransformationParameter)
from .descriptor import Enum, Field, Message


def parse_solver_prototxt(text: str) -> SolverParameter:
    """Text prototxt → SolverParameter (Utils.GetSolverParam analog)."""
    return SolverParameter.from_text(text)


def parse_net_prototxt(text: str) -> NetParameter:
    """Text prototxt → NetParameter (Utils.GetNetParam analog)."""
    return NetParameter.from_text(text)


def read_solver(path: str) -> SolverParameter:
    with open(path, "r") as f:
        return parse_solver_prototxt(f.read())


def read_net(path: str) -> NetParameter:
    with open(path, "r") as f:
        return parse_net_prototxt(f.read())
