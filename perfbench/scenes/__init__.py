"""Scene builders, one module a configuration: ``describe(config, settings,
seed)`` returns the scene as plain data (numpy arrays, numbers and
strings), which `perfbench.reference` reads itself and which is handed to
the port. A module may also define ``build_renderer(desc, seed, device)``,
which builds the port's `Renderer` from the description alone through the
port's public scene API (`import rpt_tpu_torch as rpt`); where it defines
none, `perfbench.harness.port_scene.build_renderer` builds it
(`port_scene.builder`)."""
