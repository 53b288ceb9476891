"""Scene builders, one module a configuration: ``describe(config, settings,
seed)`` returns the scene as plain data (numpy arrays, numbers and
strings), which `perfbench.harness.port_scene` hands to the port and
`perfbench.reference` reads itself."""
