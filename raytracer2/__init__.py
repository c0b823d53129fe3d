"""raytracer2 — a real-time ReSTIR path-tracing framework in JAX.

A ground-up JAX/XLA rebuild of the capabilities of the reference
Vulkan/Rust renderer DerEchteKarsten/RayTracer2 (see SURVEY.md): glTF scene
import into SoA device arrays, LBVH ray traversal, a pure-functional ReSTIR
DI/GI resampling library, polymorphic light sampling with PDF mip pyramids,
AgX tonemapping, and a brute-force reference path tracer as the built-in
correctness oracle — sharded over pixel space across devices.

Layer map (mirrors SURVEY.md §1):
- utils/     packing, RNG, BRDF math                  (GLSL helper headers)
- scene/     glTF/EXR import, cameras, SoA scene       (L1/L2)
- models/    procedural benchmark scenes               (test/bench assets)
- ops/       intersection, LBVH build, traversal, mips (Vulkan RT pipeline)
- lights/    polymorphic lights, light table, PDF tex  (prepare_lights)
- restir/    pure-functional reservoir resampling      (vendored RTXDI SDK)
- render/    frame-graph passes: gbuffer, DI, GI, post (raygen shaders)
- parallel/  device mesh, pixel sharding, halo exchange (new: multi-device)
"""

__version__ = "0.1.0"
