"""Distribution: logical-axis sharding rules onto torch device meshes."""
