"""Distribution: sharding specs over meshes (``sharding``)."""
