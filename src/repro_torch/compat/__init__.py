"""The mesh type and the ambient-mesh context of the port's sharding."""
