"""The host trust engine, failure attribution and session log, the batched
trust scan and the policy replay."""
