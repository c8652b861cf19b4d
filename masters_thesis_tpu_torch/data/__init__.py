"""The device-resident beta store; the input pipeline is the JAX
package's ``data.pipeline``, shared."""
