"""Loss primitives, anchor matching / sampling and the projection rig."""
