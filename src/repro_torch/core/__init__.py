"""Pipeline engines and the CLI surface that configures them."""
