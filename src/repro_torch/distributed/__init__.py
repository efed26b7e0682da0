"""The distributed layer: sharding rules, layout pins and the model
under a device mesh."""
