"""Plain references, one module a configuration, named after it. They
import neither the port nor JAX and take nothing the port made."""
