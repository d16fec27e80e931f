"""The simulation harness: terrain, disturbances, physics."""
