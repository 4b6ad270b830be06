"""Gossip membership (ref nomad/serf.go + vendored hashicorp/serf &
memberlist: LAN server discovery feeding raft membership and the RPC
server tables, with autopilot-style dead-server cleanup)."""

from .swim import Gossip, Member

__all__ = ["Gossip", "Member"]
