"""Distributed-training pieces of the port that run on one card: gradient
compression (``compression``).  Sharding and the mesh wait for the pod
tooling (ROADMAP Queue 1 item 7)."""
