"""The trust scan and the policy replay of the port."""
