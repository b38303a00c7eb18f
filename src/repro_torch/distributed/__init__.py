"""Distributed-training pieces of the port: gradient compression
(``compression``, with the int8 all-reduce ``compressed_psum``) and
logical-axis sharding over a ``DeviceMesh`` (``sharding``)."""
